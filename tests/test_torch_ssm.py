"""The port's Mamba-2 SSD module against the JAX package's, on the CPU: the
same seeded numpy inputs and the same weights (JAX-initialized, moved
across with ``params_from_numpy``) through both, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as jssm
from repro.models.params import materialize as jmaterialize

import repro_torch.models.ssm as tssm
from repro_torch.interop import params_from_numpy
from repro_torch.models.params import materialize

#: f32 on both sides: sums in another order (rtol 1e-4, atol 1e-5)
RTOL, ATOL = 1e-4, 1e-5
DIMS = {"one_group": dict(d_model=32, d_inner=64, headdim=16, d_state=8),
        "two_groups": dict(d_model=32, d_inner=64, headdim=16, d_state=8,
                           n_groups=2)}


def _pair(dims, seed=0):
    """The reference's init with small random offsets on every leaf: its
    zeros and ones (``dt_bias``, ``A_log``, ``D``, ``norm``) would hide
    half the arithmetic."""
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float32)
                              + rng.standard_normal(a.shape) * 0.1, a.dtype),
        jmaterialize(jssm.ssd_defs(jssm.SSMDims(**dims)),
                     jax.random.key(seed)))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def test_dims_and_defs_match():
    for kw in DIMS.values():
        jd, td = jssm.SSMDims(**kw), tssm.SSMDims(**kw)
        assert (td.n_heads, td.conv_dim) == (jd.n_heads, jd.conv_dim)
        assert {k: v.__dict__ for k, v in tssm.ssd_defs(td).items()} == \
            {k: v.__dict__ for k, v in jssm.ssd_defs(jd).items()}
        for batch in (1, 3):
            assert {k: v.__dict__ for k, v in
                    tssm.ssd_cache_defs(batch, td).items()} == \
                {k: v.__dict__ for k, v in
                 jssm.ssd_cache_defs(batch, jd).items()}


@pytest.mark.parametrize("dims", list(DIMS))
@pytest.mark.parametrize("L,chunk", [(48, 16), (40, 16), (2, 16)],
                         ids=["multiple", "not_multiple", "shorter_than_conv"])
def test_ssd_forward_with_state(dims, L, chunk):
    """Output, final state S and the raw conv tail (bf16 in both: the same
    f32 value rounded once, so one bf16 step at most) match; ``L`` not a
    multiple of ``chunk`` runs as one chunk of ``L``, as in the
    reference."""
    jp, tp = _pair(DIMS[dims])
    jd, td = jssm.SSMDims(**DIMS[dims]), tssm.SSMDims(**DIMS[dims])
    x = _x((2, L, 32))
    jy, jc = jssm.ssd_forward_with_state(jp, jnp.asarray(x), jd, chunk)
    ty, tc = tssm.ssd_forward_with_state(tp, torch.from_numpy(x), td, chunk)
    _close(ty, jy)
    _close(tssm.ssd_forward(tp, torch.from_numpy(x), td, chunk), jy)
    assert tc["S"].dtype == torch.float32 and tc["conv"].dtype == \
        torch.bfloat16 and tc["conv"].is_contiguous()
    _close(tc["S"], jc["S"])
    assert tuple(tc["conv"].shape) == jc["conv"].shape
    _close(tc["conv"], jc["conv"], rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dims", list(DIMS))
def test_ssd_decode_writes_the_cache_in_place(dims):
    """Three decode steps from a random state: each step's output and new
    cache match the reference's, and the port's new state is written into
    the cache tensors it was given."""
    jp, tp = _pair(DIMS[dims], seed=1)
    jd, td = jssm.SSMDims(**DIMS[dims]), tssm.SSMDims(**DIMS[dims])
    rng = np.random.default_rng(2)
    S = rng.standard_normal((2, td.n_heads, td.d_state, td.headdim)
                            ).astype(np.float32)
    conv = rng.standard_normal((2, td.conv_width - 1, td.conv_dim)
                               ).astype(np.float32)
    jc = {"S": jnp.asarray(S), "conv": jnp.asarray(conv)}
    tc = {"S": torch.from_numpy(S.copy()), "conv": torch.from_numpy(
        conv.copy())}
    s_buf, conv_buf = tc["S"], tc["conv"]
    for t in range(3):
        x = _x((2, 1, 32), seed=10 + t)
        jy, jc = jssm.ssd_decode(jp, jnp.asarray(x), jc, jd)
        ty, tc = tssm.ssd_decode(tp, torch.from_numpy(x), tc, td)
        _close(ty, jy)
        _close(tc["S"], jc["S"])
        _close(tc["conv"], jc["conv"])
        assert tc["S"] is s_buf and tc["conv"] is conv_buf


def test_ssd_matches_naive_recurrence():
    """The twin of the reference's test: chunked SSD == the step-by-step
    state recurrence (the decode from a zero state), its own bound."""
    dims = tssm.SSMDims(d_model=32, d_inner=64, headdim=16, d_state=8)
    p = materialize(tssm.ssd_defs(dims), torch.Generator().manual_seed(1))
    B, L = 2, 48
    x = torch.from_numpy(_x((B, L, 32)))
    y_chunked = tssm.ssd_forward(p, x, dims, chunk=16)
    cache = {"S": torch.zeros((B, dims.n_heads, dims.d_state, dims.headdim)),
             "conv": torch.zeros((B, dims.conv_width - 1, dims.conv_dim))}
    ys = []
    for t in range(L):
        yt, cache = tssm.ssd_decode(p, x[:, t:t + 1], cache, dims)
        ys.append(yt)
    np.testing.assert_allclose(y_chunked.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("L,chunk", [(32, 8), (64, 16), (40, 40)])
def test_ssd_chunk_invariance(L, chunk):
    """The twin of the reference's property: the output does not depend on
    the chunk size (its bound)."""
    dims = tssm.SSMDims(d_model=16, d_inner=32, headdim=8, d_state=4)
    p = materialize(tssm.ssd_defs(dims), torch.Generator().manual_seed(2))
    x = torch.from_numpy(_x((1, L, 16), seed=1))
    np.testing.assert_allclose(tssm.ssd_forward(p, x, dims, chunk=chunk)
                               .numpy(),
                               tssm.ssd_forward(p, x, dims, chunk=L).numpy(),
                               rtol=2e-2, atol=2e-3)


def test_strong_decay_stays_finite():
    """A large A and dt make exp(acum_q - acum_k) overflow above the
    diagonal: those entries are selected away, never multiplied by zero,
    so no nan reaches the output (and the reference agrees)."""
    kw = DIMS["one_group"]
    jp, tp = _pair(kw)
    jp = dict(jp, A_log=jnp.full_like(jp["A_log"], 4.0),
              dt_bias=jnp.full_like(jp["dt_bias"], 3.0))
    tp = dict(tp, A_log=torch.full_like(tp["A_log"], 4.0),
              dt_bias=torch.full_like(tp["dt_bias"], 3.0))
    x = _x((2, 32, 32))
    ty = tssm.ssd_forward(tp, torch.from_numpy(x), tssm.SSMDims(**kw), 16)
    assert torch.isfinite(ty).all()
    _close(ty, jssm.ssd_forward(jp, jnp.asarray(x), jssm.SSMDims(**kw), 16))


#: the smallest input on which the reference's SSD gradients are nan
#: (``ROADMAP.md`` §3): the defs' inits (``A_log`` 1, ``dt_bias`` 0), one
#: sequence of 256 tokens, one chunk of 256.  A chunk's summed |dt*A|
#: (about 0.7 a token) passes 88, where exp(acum_q - acum_k) above the
#: diagonal overflows to inf
FAULT_DIMS = dict(d_model=8, d_inner=16, headdim=8, d_state=4)
#: leaves whose reference gradients are nan at chunk 256: every path to
#: them runs through the decay's exponent
FAULT_NAN = {"in_proj", "conv_w", "conv_b", "A_log", "dt_bias"}


def _fault_case():
    jd = jssm.SSMDims(**FAULT_DIMS)
    jp = jmaterialize(jssm.ssd_defs(jd), jax.random.key(0))
    npp = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 256, 8)).astype(np.float32)
    ct = rng.standard_normal((1, 256, 8)).astype(np.float32)
    return jd, npp, x, ct


def _ref_grads(jd, npp, x, ct, chunk):
    def loss(p):
        return jnp.sum(jssm.ssd_forward(p, jnp.asarray(x), jd, chunk) * ct)
    return {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss))(
        {k: jnp.asarray(v) for k, v in npp.items()}).items()}


def test_ssd_gradients_stay_finite_at_chunk_256():
    """The fault of ``ROADMAP.md`` §3 ("differs on purpose"): on its input
    the reference's forward is finite but its gradients of ``in_proj``,
    ``conv_w``, ``conv_b``, ``A_log`` and ``dt_bias`` are nan at chunk 256.
    The port masks the exponent, not the product: every gradient is
    finite, equal to the reference's (within 1e-4 of the leaf's max)
    wherever those are finite, and within 1e-3 of each leaf's max of the
    reference's gradients at chunk 16, where nothing overflows (measured
    1.6e-5).  The forward stays within 1e-5 of the reference's max."""
    jd, npp, x, ct = _fault_case()
    td = tssm.SSMDims(**FAULT_DIMS)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in npp.items()}
    y = tssm.ssd_forward(tp, torch.from_numpy(x), td, chunk=256)
    (y * torch.from_numpy(ct)).sum().backward()
    jy = np.asarray(jssm.ssd_forward({k: jnp.asarray(v)
                                      for k, v in npp.items()},
                                     jnp.asarray(x), jd, 256))
    assert np.isfinite(jy).all()
    assert np.abs(y.detach().numpy() - jy).max() < 1e-5 * np.abs(jy).max()
    at256 = _ref_grads(jd, npp, x, ct, 256)
    at16 = _ref_grads(jd, npp, x, ct, 16)
    assert {k for k, g in at256.items() if not np.isfinite(g).all()} == \
        FAULT_NAN
    for name, leaf in tp.items():
        got = leaf.grad.numpy()
        assert np.isfinite(got).all(), name
        scale = np.abs(at16[name]).max()
        assert np.abs(got - at16[name]).max() < 1e-3 * scale, name
        if name not in FAULT_NAN:
            assert np.abs(got - at256[name]).max() < \
                1e-4 * np.abs(at256[name]).max(), name
