"""The control at a size a test run holds: on the same weights and rows,
the reference computed in fp8 reads farther from the f32 reference than
the program does. (On the chip, at the cells' own sizes:
``python3 bench/control.py``.)"""

import time

import pytest

from bench import harness
from bench.tests.tiny import tiny


def test_training_control():
    cell = tiny("yi6b.train_stream")
    drv = harness.driver(cell)
    out = drv.run(cell, 2**31 + 5, 1.0, False, time.perf_counter(), device="cpu", variants=(("fp8", False),))
    r = out["readings"]
    prog = {c.name: c.value for c in drv.compare(cell, r["program"], r["reference"])}
    ctrl = {c.name: c.value for c in drv.compare(cell, r["fp8"], r["reference"])}
    assert ctrl["grad_diff"] > 3 * prog["grad_diff"] and ctrl["loss_gap"] > prog["loss_gap"]


def test_serving_control():
    cell = tiny("yi6b.serve_rate")
    out = harness.driver(cell).run(cell, 3, 2.0, False, time.perf_counter(), device="cpu",
                                   variants=("fp8", "token"))
    g = out["readings"]["gaps"]
    assert g["fp8"] > g["served"] and g["token"] > g["served"]


@pytest.mark.parametrize("name", ["yi6b.train_stream", "mamba2.train_stream"])
def test_reference_is_the_programs_function(name):
    """The program with f32 activations (bf16 weights) and the plain
    reference give one loss and one gradient: the reference computes the
    program's function. (mamba2-2.7b has no cell: its bf16 residual
    departs from the configuration's residual_in_fp32; PERF.md.)"""
    import torch

    from bench import gen, models
    from repro_torch.models.model import StreamModel
    from repro_torch.models.policy import Policy

    cell = tiny(name, {})
    maker = harness.weight_maker(cell, 11, "cpu")
    model = StreamModel(harness.configuration(cell).arch_config(cell.config), Policy(compute_dtype="float32"),
                        device="cpu", generator=None)
    params = maker.fill_tree(model.param_tree())
    paths = [p for p, _ in models.tree_paths(params)]
    for _, t in models.tree_paths(params):
        t.requires_grad_(True)
    tokens = torch.as_tensor(gen.markov_corpus(2, int(cell.config["vocab_size"]), 32, 11, 8), dtype=torch.long)
    loss, _ = model.loss(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, [t for _, t in models.tree_paths(params)])
    ref = harness.reference(cell)
    dec = ref.decoder(cell.config, {p: maker.make(p, tuple(t.shape), t.dtype).float()
                                    for p, t in models.tree_paths(params)})
    ref_loss, ref_grads = dec.loss_and_grads(tokens)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for p, g in zip(paths, grads):  # a bf16 leaf's gradient is stored in bf16: 2^-9 an element
        assert ref.C.norm(g) == pytest.approx(ref.C.norm(ref_grads[p]), rel=1e-3, abs=1e-7), p
