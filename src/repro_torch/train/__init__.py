from repro_torch.train import checkpoint, compression
from repro_torch.train.optimizer import Optimizer, adamw, adamw8bit, clip_by_global_norm, cosine_schedule
from repro_torch.train.trainer import TrainingJob, build_train_step, dp_train_step, make_state, state_pspecs
