"""The port's optimizer (contrastyou_tpu_torch/engine/optim.py) held against the
JAX package's ``create_optimizer`` (add_decayed_weights + optax.radam behind the
warmup-cosine schedule) on the same gradients.

Tolerances: the per-step parameter updates, read back as differences of
~1e-2 parameters (exact to ~1e-9), at rtol 1e-5 / atol 1e-8 for every step:
the same f32 arithmetic in another order. The rectification factor r is
ill-conditioned at the first rectified steps (ro - 4 is a difference of
~2000-sized terms), so this holds only because the port forms ro and r in f32
in optax's order. optax runs under ``jax.jit`` here, as in every JAX train
step: jitted, XLA rounds b2^t correctly, while eager JAX computes it by
repeated squaring, one or two ulps off, which moves r by 0.6% at step 6.
The schedule at rtol 1e-4 (optax evaluates it in
f32: the warmup line ``(base - peak) * frac + peak`` cancels at step 0,
leaving ulp(3e-5) / 1e-7 ~ 2e-5 of error there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastyou_tpu.engine.optim import create_optimizer as jcreate
from contrastyou_tpu_torch.engine.optim import create_optimizer, warmup_schedule
from torch_parity import close, t

torch.set_num_threads(1)

OPTIM = {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-2}
SCHED = {"multiplier": 3, "warmup_max": 2}
SHAPES = [(3, 3, 4, 8), (8,), (8,), (16, 5), (5,)]


def _run(n_steps):
    rng = np.random.default_rng(0)
    # small parameters keep their f32 ulp far below the ~1e-3 updates, so
    # the updates read back as differences stay exact to ~1e-6
    params = [(rng.standard_normal(s) * 1e-2).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(n_steps)]
    # JAX
    tx, _ = jcreate(OPTIM, SCHED, max_epoch=5, steps_per_epoch=3)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    jdeltas = []
    for g in grads:
        upd, state = update([jnp.asarray(x) for x in g], state, jp)
        new = [p + u for p, u in zip(jp, upd)]
        jdeltas.append([np.asarray(a) - np.asarray(b) for a, b in zip(new, jp)])
        jp = new
    # port
    tp = [torch.nn.Parameter(t(p)) for p in params]
    opt, _ = create_optimizer(tp, OPTIM, SCHED, max_epoch=5, steps_per_epoch=3)
    tdeltas = []
    for g in grads:
        before = [p.detach().clone() for p in tp]
        for p, x in zip(tp, g):
            p.grad = t(x)
        opt.step()
        tdeltas.append([p.detach() - b for p, b in zip(tp, before)])
    return jp, tp, jdeltas, tdeltas


@pytest.mark.parametrize("n_steps", [1, 10])
def test_radam_updates_match_optax(n_steps):
    """Step 1..4 are unrectified (ro < 5), the rest rectified; 10 steps run
    through the warmup into the cosine phase."""
    jp, tp, jd, td = _run(n_steps)
    for step, (a, b) in enumerate(zip(td, jd)):
        for x, y in zip(a, b):
            close(x, y, rtol=1e-5, atol=1e-8, what=f"update {step + 1}")
    for x, y in zip(tp, jp):
        close(x, y, rtol=1e-5, atol=1e-7)


def test_schedule_matches_optax():
    _, jsched = jcreate({"name": "radam", "lr": 1e-7, "weight_decay": 1e-5},
                        {"multiplier": 300, "warmup_max": 10},
                        max_epoch=75, steps_per_epoch=200)
    sched = warmup_schedule(base_lr=1e-7, multiplier=300, warmup_max_epoch=10,
                            max_epoch=75, steps_per_epoch=200)
    for step in (0, 1, 999, 1999, 2000, 2001, 8000, 14999, 15000, 20000):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-4,
                                   err_msg=str(step))


def test_unported_choices_raise():
    """Names the JAX package's ``create_optimizer`` does not know raise
    ``KeyError`` as there (adam, adamw, sgd, poly and step are ported:
    tests/test_torch_optim_knobs.py)."""
    with pytest.raises(KeyError):
        create_optimizer([torch.nn.Parameter(torch.zeros(1))], {"name": "lamb"}, None,
                         max_epoch=1, steps_per_epoch=1)
    with pytest.raises(KeyError):
        warmup_schedule(base_lr=1.0, multiplier=1, warmup_max_epoch=1, max_epoch=2,
                        steps_per_epoch=1, name="exponential")


_NO_DYNAMO = """
import sys
import torch
from contrastyou_tpu_torch.engine.optim import create_optimizer
ps = [torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6).reshape(2, 3)),
      torch.nn.Parameter(torch.ones(4))]
opt, _ = create_optimizer(ps, {"name": "RAdam", "lr": 1e-3, "weight_decay": 1e-2},
                          {"multiplier": 3, "warmup_max": 2}, max_epoch=5, steps_per_epoch=3)
for k in range(3):
    for p in ps:
        p.grad = torch.full_like(p, 0.5 - k)
    opt.step()
    opt.zero_grad()
sd = opt.state_dict()
opt.load_state_dict(sd)
assert all(p.grad is None for p in ps)
assert "torch._dynamo" not in sys.modules, "torch._dynamo imported"
"""


def test_optimizer_methods_import_no_dynamo():
    """``zero_grad``, ``add_param_group``, ``state_dict`` and
    ``load_state_dict`` are ``torch.optim.Optimizer``'s own, called without
    the ``torch._dynamo.disable`` wrapper whose first call imports
    ``torch._dynamo`` (a fresh process imports it nowhere), and give what
    the wrapped methods give: the state dict of three steps, and a second
    optimizer loaded from it steps as the first does."""
    import copy
    import subprocess
    import sys
    run = subprocess.run([sys.executable, "-c", _NO_DYNAMO], capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    assert run.returncode == 0, run.stderr[-2000:]

    def make():
        ps = [torch.nn.Parameter(torch.linspace(-1.0, 1.0, 6).reshape(2, 3)),
              torch.nn.Parameter(torch.ones(4))]
        return ps, create_optimizer(ps, OPTIM, SCHED, max_epoch=5, steps_per_epoch=3)[0]

    ps, opt = make()
    for k in range(3):
        for p in ps:
            p.grad = torch.full_like(p, 0.5 - k)
        opt.step()
    sd = opt.state_dict()
    want = torch.optim.Optimizer.state_dict(opt)     # the wrapped method
    assert sd["count"] == 3 and sd["mini_step"] == 0
    assert sd["param_groups"] == want["param_groups"]
    assert sd["state"].keys() == want["state"].keys()
    for i in sd["state"]:
        for name, v in sd["state"][i].items():
            torch.testing.assert_close(v, want["state"][i][name], rtol=0, atol=0)
    qs, other = make()
    with torch.no_grad():
        for q, p in zip(qs, ps):
            q.copy_(p)
    other.load_state_dict(copy.deepcopy(sd))     # as from a checkpoint: no shared moments
    assert other.count == 3
    for p, q in zip(ps, qs):
        p.grad = torch.full_like(p, 0.25)
        q.grad = torch.full_like(q, 0.25)
    opt.step()
    other.step()
    for p, q in zip(ps, qs):
        torch.testing.assert_close(q, p, rtol=0, atol=0)
    other.zero_grad()
    assert all(q.grad is None for q in qs)
