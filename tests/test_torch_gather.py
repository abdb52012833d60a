"""The gather probes' kernels P1-P3 (gens_torch/ops/gather.py) on the CPU:
their plain versions against the JAX function each probe computes, and
against the probes' own Pallas kernel bodies run with
``pl.pallas_call(..., interpret=True)``, on the same numpy inputs, exactly;
the wrappers' CPU rule and input checks, the row-gather copy plan, and the
probe entry point's device rule. The kernels themselves are held against
these plain versions on the card (tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gens_torch.ops import gather as gk
from gens_torch.utils.profiling import counter

import _torch_common  # noqa: E402,F401  (one torch thread per worker)

N = 4096
TABLES = [(729, 108), (4096, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


# -- the probes' kernel bodies, copied verbatim -------------------------------

# scripts/gather_probe.py:94-95
def vmem_gather_kernel(idx_ref, table_ref, out_ref):
    out_ref[:] = jnp.take(table_ref[:], idx_ref[:], axis=0)


# scripts/gather_probe2.py:54-57
def k_tala(idx_ref, table_ref, out_ref):
    idx2 = jnp.broadcast_to(idx_ref[:][:, None],
                            (idx_ref.shape[0], table_ref.shape[1]))
    out_ref[:] = jnp.take_along_axis(table_ref[:], idx2, axis=0)


# scripts/gather_probe2.py:59-67
def k_onehot(idx_ref, table_ref, out_ref):
    # one-hot matmul gather: MXU does the addressing
    Mr = table_ref.shape[0]
    idx = idx_ref[:]
    oh = (idx[:, None] == jax.lax.broadcasted_iota(
        jnp.int32, (idx.shape[0], Mr), 1)).astype(jnp.bfloat16)
    out_ref[:] = jnp.dot(oh, table_ref[:].astype(jnp.bfloat16),
                         preferred_element_type=jnp.float32
                         ).astype(out_ref.dtype)


def pallas_probe(kernel, table, idx, tile=1024):
    """The probes' pallas_call (gather_probe2.py:69-85), in interpret mode."""
    n = idx.shape[0]
    mr, w = table.shape
    return pl.pallas_call(
        kernel,
        grid=(n // tile,),
        in_specs=[
            pl.BlockSpec((tile,), lambda i: (i,), memory_space=pltpu.VMEM),
            pl.BlockSpec((mr, w), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile, w), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, w), table.dtype),
        interpret=True,
    )(idx, table)


# -- the JAX functions --------------------------------------------------------

def jax_take(table, idx):
    return jnp.take(table, idx, axis=0)


def jax_take_along(table, idx):
    idx2 = jnp.broadcast_to(idx[:, None], (idx.shape[0], table.shape[1]))
    return jnp.take_along_axis(table, idx2, axis=0)


def jax_onehot(table, idx):
    oh = jax.nn.one_hot(idx, table.shape[0], dtype=jnp.bfloat16)
    return jnp.dot(oh, table.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32).astype(table.dtype)


PROBES = {
    "P1": (gk.row_gather_take, jax_take, vmem_gather_kernel),
    "P2": (gk.row_gather_take_along, jax_take_along, k_tala),
    "P3": (gk.onehot_gather, jax_onehot, k_onehot),
}


def _inputs(rows, width, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, width).astype(np.float32),
            rng.randint(0, rows, N).astype(np.int32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _both(table_np, idx_np, dt):
    jdt, tdt = DTYPES[dt]
    return ((jnp.asarray(table_np).astype(jdt), jnp.asarray(idx_np)),
            (torch.from_numpy(table_np).to(tdt), torch.from_numpy(idx_np)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,width", TABLES)
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_plain_matches_jax_function(probe, rows, width, dt):
    wrapper, jfn, _ = PROBES[probe]
    table_np, idx_np = _inputs(rows, width, rows + width)
    (jt, ji), (tt, ti) = _both(table_np, idx_np, dt)
    before = counter(probe.lower() + ".launches")
    got = wrapper(tt, ti)  # CPU tensors: the plain version
    assert counter(probe.lower() + ".launches") == before
    assert got.dtype == tt.dtype and tuple(got.shape) == (N, width)
    np.testing.assert_array_equal(_np(got), _np(jax.jit(jfn)(jt, ji)))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows,width", TABLES)
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_plain_matches_probe_kernel_interpreted(probe, rows, width, dt):
    wrapper, _, kernel = PROBES[probe]
    table_np, idx_np = _inputs(rows, width, 7 * rows + width)
    (jt, ji), (tt, ti) = _both(table_np, idx_np, dt)
    ref = jax.jit(lambda a, b: pallas_probe(kernel, a, b))(jt, ji)
    np.testing.assert_array_equal(_np(wrapper(tt, ti)), _np(ref))


def test_plain_versions_outside_the_table():
    table = torch.randn((5, 3))
    idx = torch.tensor([-7, -1, 0, 4, 5, 99], dtype=torch.int32)
    # the row gather clamps, as XLA's gather does
    torch.testing.assert_close(gk.row_gather_plain(table, idx),
                               table[[0, 0, 0, 4, 4, 4]], rtol=0, atol=0)
    # the one-hot product gives a zero row
    got = gk.onehot_gather_plain(table, idx)
    assert torch.count_nonzero(got[[0, 1, 4, 5]]) == 0
    torch.testing.assert_close(got[[2, 3]],
                               table[[0, 4]].bfloat16().float(), rtol=0,
                               atol=0)


def test_onehot_plain_across_its_slices(monkeypatch):
    monkeypatch.setattr(gk, "_PLAIN_ELEMS", 1000 * 729)
    table_np, idx_np = _inputs(729, 108, 3)
    t = torch.from_numpy(table_np)
    got = gk.onehot_gather_plain(t, torch.from_numpy(idx_np))
    torch.testing.assert_close(got, t.bfloat16().float()[idx_np], rtol=0,
                               atol=0)


@pytest.mark.parametrize("wrapper", [gk.row_gather_take,
                                     gk.row_gather_take_along,
                                     gk.onehot_gather])
def test_wrappers_check_inputs(wrapper):
    table = torch.randn((16, 8))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        wrapper(table.double(), idx)
    with pytest.raises(ValueError):
        wrapper(table, idx.long())
    with pytest.raises(ValueError):
        wrapper(table.t(), idx)
    with pytest.raises(ValueError):
        wrapper(table[:0], idx)
    with pytest.raises(ValueError):
        wrapper(table, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        wrapper(table.to("meta"), idx.to("meta"))


@pytest.mark.parametrize("width,elem,ptrs,plan", [
    (128, 4, (0, 512), (16, 32)),    # f32 128: 32 units of 16 B
    (128, 2, (0, 512), (16, 16)),    # bf16 128: 256 B
    (108, 4, (0, 512), (16, 32)),    # f32 108: 432 B = 27 x 16
    (108, 2, (0, 512), (8, 32)),     # bf16 108: 216 B, 8-byte grain
    (36, 2, (0, 512), (8, 16)),      # bf16 36: 72 B
    (4, 4, (0, 512), (16, 4)),       # f32 4: one 16-byte unit
    (128, 4, (0, 520), (8, 32)),     # an output 8 B off 16 narrows the grain
    (3, 2, (0, 512), (2, 4)),        # bf16 3: 6 B
])
def test_copy_plan(width, elem, ptrs, plan):
    assert gk.copy_plan(width * elem, *ptrs) == plan


def test_gather_probe_needs_a_card(monkeypatch):
    from gens_torch.probes import gather as probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(["--iters", "1"])


def test_gather_probe_jitter_and_rows():
    from gens_torch.probes import gather as probe

    idx = torch.tensor([0, 3, 6], dtype=torch.int32)
    sets = probe.jittered(idx, 7, 3)
    assert [s.tolist() for s in sets] == [[0, 3, 6], [1, 4, 0], [2, 5, 1]]
    assert all(s.dtype == torch.int32 for s in sets)
    # the TPU scripts' lists of rows, each kept
    assert len(probe.E1) == 11 and len(probe.E2) == 5 and len(probe.E3) == 2
    assert len(probe.A) == 5 and len(probe.B) == 5 and len(probe.C) == 5
    row = probe._row(1.0, 1 << 20, 128, 4, 5.4e8, 2.0 * (1 << 20) * 4096 * 128)
    assert row["bound_by"] == "operations"
    assert abs(row["bound_ms"] - 2.0 * (1 << 20) * 4096 * 128 / 989e12 * 1e3
               ) < 1e-9
