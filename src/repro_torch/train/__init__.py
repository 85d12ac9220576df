from repro_torch.train import checkpoint
from repro_torch.train.optimizer import Optimizer, adamw, clip_by_global_norm, cosine_schedule
from repro_torch.train.trainer import TrainingJob, build_train_step, make_state
