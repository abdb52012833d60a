"""The finetune step's CUDA graph (``FinetuneStep`` on the card): captured
at the second of two like calls, a replay gives what the eager step gives
from the same state (metrics, gradients, updated tensors, to the rounding
of the backward's scatter-adds), and so does a call that falls back to
the eager step; on the CPU no graph is made; the capture's cumprod has
torch's gradient.
Imports neither jax nor gens_tpu, so it runs on a machine with only
PyTorch:

    python -m pytest --noconftest -q tests/test_torch_finetune_graph.py

The card's tests skip where there is no CUDA device (a graph has no CPU
mode)."""

import copy

import numpy as np
import pytest
import torch

from gens_torch.config import Config
from gens_torch.data.synthetic import SyntheticDataset
from gens_torch.models.gens import GenSModel
from gens_torch.train.step import FinetuneStep

HW = (64, 64)


def _config():
    cfg = Config()
    m = cfg.model
    m.feature_network.d_enc = (8, 8, 8, 8, 8)
    m.volume.volume_dims = (32, 16, 8, 4, 2)
    m.sdf_network.d_hidden = 48
    m.sdf_network.n_layers = 4
    m.sdf_network.skip_in = (2,)
    m.sdf_network.d_out = 17
    m.render.n_samples = 16
    m.render.n_importance = 16
    m.render.up_sample_steps = 2
    m.render.patch_size = 5
    m.render.n_sparse_pts = 64
    return cfg


def _setup(device):
    cfg = _config()
    torch.manual_seed(0)
    model = GenSModel(cfg.model).to(device)
    images = SyntheticDataset(1, 3, HW, mode="finetune").get_all_images()
    leaves = model.init_volumes(*[torch.from_numpy(images[k]).to(device)
                                  for k in ("imgs", "intrs", "c2ws")])
    return model, FinetuneStep(model, cfg, *leaves)


def _batches(device, n):
    data = SyntheticDataset(1, 3, HW, n_rays=32, mode="finetune")
    out = []
    for i in range(n):
        raw = data.get_random_rays(i % 3)
        b = {k: torch.from_numpy(v).to(device) for k, v in raw.items()
             if isinstance(v, np.ndarray) and v.dtype == np.float32}
        b["view_ids"] = torch.from_numpy(
            np.asarray(raw["view_ids"])).to(device)
        out.append(b)
    return out


def _trained(model, step):
    return [p for top in ("sdf", "blending", "variance")
            for p in getattr(model, top).parameters()] + step.volumes


def _gap(x, y):
    return float(torch.linalg.norm((x - y).double())
                 / torch.linalg.norm(y.double()).clamp_min(1e-30))


@pytest.mark.cuda
def test_replays_match_the_eager_step():
    """Each untimed call from the second on (a capture, replays, and a
    call whose ratio was not captured) against a timed, eager call from
    the same state, draws and batch: the same metrics, gradients and
    updated tensors, to the rounding of the backward's scatter-adds,
    which sum in another order on every run (Adam carries it further
    where a gradient is near zero)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a graph has no CPU mode)")
    dev = torch.device("cuda")
    model, step = _setup(dev)
    batches = _batches(dev, 5)
    gen = torch.Generator().manual_seed(7)
    step(batches[0], 1.0, generator=gen)
    assert step.graph is None
    trained = _trained(model, step)
    for b, ratio in zip(batches[1:], (1.0, 1.0, 0.5, 1.0)):
        before = [p.detach().clone() for p in trained]
        opt = copy.deepcopy(step.optimizer.state_dict())
        sched = copy.deepcopy(step.scheduler.state_dict())
        draws = gen.get_state()
        got = step(b, ratio, generator=gen)
        assert step.graph is not None and step.graph.key[0] == 1.0
        got_grad = [p.grad.clone() for p in trained]
        got_after = [p.detach().clone() for p in trained]
        with torch.no_grad():
            for p, v in zip(trained, before):
                p.copy_(v)
        step.optimizer.load_state_dict(opt)
        step.scheduler.load_state_dict(sched)
        gen.set_state(draws)
        want = step(b, ratio, generator=gen, timing=True)
        want.pop("phase_ms")
        assert got.keys() == want.keys()
        for k in want:
            assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-8), k
        for p, g, a in zip(trained, got_grad, got_after):
            assert _gap(g, p.grad) < 1e-5
            assert _gap(a, p.detach()) < 1e-4


def test_no_graph_off_the_card():
    model, step = _setup(torch.device("cpu"))
    (b,) = _batches(torch.device("cpu"), 1)
    m = step(b, 1.0, generator=torch.Generator().manual_seed(7))
    assert step.graph is None
    assert torch.isfinite(m["loss"])
    assert all(v.grad is not None for v in step.volumes)


@pytest.mark.parametrize("shape,dim", [((64, 129), -1), ((7, 5, 3), 1)])
def test_cumprod_gradient_is_torchs(shape, dim):
    """The capture's cumprod gives torch's value and, on an input with no
    zero, torch's gradient bit for bit."""
    from gens_torch.ops.capture import _CumprodNoZero

    g = torch.Generator().manual_seed(0)
    x = torch.rand(shape, generator=g) * 0.9 + 1e-7
    up = torch.randn(shape, generator=g)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    want = torch.cumprod(a, dim)
    got = _CumprodNoZero.apply(b, dim)
    assert torch.equal(got, want)
    (ga,) = torch.autograd.grad(want, a, up)
    (gb,) = torch.autograd.grad(got, b, up)
    assert torch.equal(gb, ga)
