"""The row kernels' plain versions (K1 ``scatter_add_plain``, K7
``scatter_add_sorted_plain``, K2 ``segment_sum_scalar_plain``, K8
``spmm_fused_plain``) and their ``acc_dtype`` keyword, on the CPU.

With the default (float32) each returns, bit for bit, the f32
``index_add_`` it returned before the keyword existed: the CPU path of the
port runs them as its kernels. With torch.float64 each is the checks'
exact reference (chip_smoke.py, tests/test_torch_cuda.py): it equals a
numpy f64 sum of the same terms within 1e-12 of the row's summed
magnitudes. Inputs come from a seed with numpy, with ids out of range, in
bf16 and f32."""
import importlib

import numpy as np
import pytest
import torch

from sgs_gnn_tpu_torch.ops import scatter as sc

# the module (ops/__init__ binds the name spmm to the function)
sp = importlib.import_module("sgs_gnn_tpu_torch.ops.spmm")

N, E, F, BAND = 37, 3001, 9, 16
F32 = torch.float32
FUNCS = ["scatter_add_plain", "scatter_add_sorted_plain",
         "segment_sum_scalar_plain", "spmm_fused_plain"]
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(dtype):
    """Ids in [-2, N + 2) (sorted for K7, whose last items are the TPU
    wrapper's padding ids N and N + band), values and weights spread over
    several binades, in ``dtype``."""
    rng = np.random.default_rng(0)
    ids = rng.integers(-2, N + 2, E).astype(np.int32)
    senders = rng.integers(-1, N + 1, E).astype(np.int32)
    vals = rng.normal(size=(E, F)) * np.exp2(rng.integers(-8, 8, (E, 1)))
    x = rng.normal(size=(N, F)) * np.exp2(rng.integers(-8, 8, (N, 1)))
    w = rng.random(E) * np.exp2(rng.integers(-8, 8, E))
    sorted_ids = np.sort(rng.integers(0, N, E)).astype(np.int32)
    sorted_ids[-6:] = N
    sorted_ids[-3:] = N + BAND
    t = torch.from_numpy
    return dict(ids=t(ids), senders=t(senders), sorted_ids=t(sorted_ids),
                vals=t(vals.astype(np.float32)).to(dtype),
                x=t(x.astype(np.float32)).to(dtype),
                w=t(w.astype(np.float32)))


def _call(name, inp, dtype, **kw):
    """``name`` on the inputs; the scalar sum takes its weights in
    ``dtype``, K8 its edge weights in f32 (it rounds them to x's type)."""
    if name == "scatter_add_plain":
        return sc.scatter_add_plain(inp["vals"], inp["ids"], N, **kw)
    if name == "scatter_add_sorted_plain":
        return sc.scatter_add_sorted_plain(inp["vals"], inp["sorted_ids"], N,
                                           BAND, 64, **kw)
    if name == "segment_sum_scalar_plain":
        return sc.segment_sum_scalar_plain(inp["w"].to(dtype), inp["ids"], N,
                                           **kw)
    return sp.spmm_fused_plain(inp["senders"], inp["ids"], inp["w"],
                               inp["x"], N, **kw)


def _f32_sum(name, inp, dtype):
    """The f32 ``index_add_`` each plain version computed before
    ``acc_dtype``, written out (dtypes explicit: another test module may
    have changed torch's default)."""
    ids = inp["ids"]
    if name == "scatter_add_plain":
        keep = (ids >= 0) & (ids < N)
        out = torch.zeros(N, F, dtype=F32)
        return out.index_add_(0, ids[keep].long(), inp["vals"][keep].float())
    if name == "scatter_add_sorted_plain":
        srt = inp["sorted_ids"]
        keep = sc.sorted_band_keep(srt, N, BAND, 64)
        out = torch.zeros(N, F, dtype=F32)
        return out.index_add_(0, srt[keep].long(), inp["vals"][keep].float())
    if name == "segment_sum_scalar_plain":
        keep = (ids >= 0) & (ids < N)
        out = torch.zeros(N, dtype=F32)
        return out.index_add_(0, ids[keep].long(),
                              inp["w"].to(dtype)[keep].float())
    s = inp["senders"]
    w = inp["w"].to(dtype).float()
    rows = inp["x"][s.clamp(0, N - 1).long()].float()
    msgs = torch.where(((s >= 0) & (s < N))[:, None], rows, 0) * w[:, None]
    keep = (ids >= 0) & (ids < N)
    out = torch.zeros(N, F, dtype=F32)
    return out.index_add_(0, ids[keep].long(), msgs[keep])


def _terms(name, inp, dtype):
    """(row of each kept term, the terms as f64 numpy)."""
    ids = inp["ids"].numpy()
    if name == "scatter_add_sorted_plain":
        keep = sc.sorted_band_keep(inp["sorted_ids"], N, BAND, 64).numpy()
        return (inp["sorted_ids"].numpy()[keep],
                inp["vals"].double().numpy()[keep])
    keep = (ids >= 0) & (ids < N)
    if name == "scatter_add_plain":
        return ids[keep], inp["vals"].double().numpy()[keep]
    if name == "segment_sum_scalar_plain":
        return ids[keep], inp["w"].to(dtype).double().numpy()[keep]
    s = inp["senders"].numpy()
    keep &= (s >= 0) & (s < N)
    w = inp["w"].to(dtype).double().numpy()
    x = inp["x"].double().numpy()
    return ids[keep], x[s[keep]] * w[keep, None]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("name", FUNCS)
def test_default_is_the_f32_sum_bit_for_bit(name, dtype):
    inp = _inputs(dtype)
    got = _call(name, inp, dtype)
    assert got.dtype == torch.float32
    assert torch.equal(got, _call(name, inp, dtype,
                                  acc_dtype=torch.float32))
    assert torch.equal(got, _f32_sum(name, inp, dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("name", FUNCS)
def test_f64_matches_a_numpy_f64_sum(name, dtype):
    inp = _inputs(dtype)
    got = _call(name, inp, dtype, acc_dtype=torch.float64)
    assert got.dtype == torch.float64
    rows, terms = _terms(name, inp, dtype)
    want = np.zeros((N,) + terms.shape[1:])
    np.add.at(want, rows, terms)
    abs_sum = np.zeros_like(want)
    np.add.at(abs_sum, rows, np.abs(terms))
    assert len(rows) > E // 2 and abs_sum.min() > 0
    assert np.all(np.abs(got.numpy() - want) <= 1e-12 * abs_sum)
