"""Non-finite particles in rows 1-2 (``fused_logq``, ``fused_rho``) on the
CPU: the port's plain ``mixture_logpdf_T``, ``fused_logq`` and ``fused_rho``
(their plain versions here) against the JAX package's XLA path, float64 and
float32, on particles with +inf at coordinate 0, +inf at a middle
coordinate, -inf at the last, a NaN and 1e20 (whose squared distance
overflows float32): the same NaN, +inf and -inf at every output, the finite
outputs close.  Then numpy mirrors of the kernels' rules that give those
values (``csrc/common.cuh`` ``WeightedLse``: a -inf term adds nothing;
``csrc/tiled.cuh`` ``SquaresEpi``: rows past D left out of the squares; the
recomputation of a squared distance that is not finite with every entry of
U read, ``maha_fp32_body``), each against the rule it replaced.  The kernels
themselves run only on the card (``chip_smoke.py``
``evaluation_nonfinite_case``)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu.mix_adapt.pmc as jpmc
from pypmc_tpu.ops import lse as jlse
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.mix_adapt import pmc
from pypmc_tpu_torch.ops import _build, kernels, lse

torch.set_num_threads(1)

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
# the particles planted: (column, coordinate, value)
PLANTED = lambda D: [(1, 0, np.inf), (2, D // 2, np.inf), (3, D - 1, -np.inf), (4, 3, np.nan),
                     (5, 1, 1e20)]
N = 9


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def _problem(D, student_t, dtype, K=3):
    """A K-component mixture (the middle one dead) in both packages and
    particles (D, N) near its means, the PLANTED ones among them."""
    rng = np.random.default_rng(D + 10 * student_t)
    a = rng.normal(0, 0.4, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a) / np.sqrt(D)
    w = rng.uniform(0.5, 1.5, K)
    w[K // 2] = 0.0
    dofs = rng.uniform(4, 12, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(dtype)
    means = rng.normal(0, 2, (K, D))
    jp, valid = jcore.make_mixture(cast(means), cast(covs), cast(w / w.sum()), cast(dofs))
    assert bool(np.asarray(valid).all())
    xT = (means[0][:, None] + rng.normal(0, 1, (D, N))).astype(dtype)
    for col, j, v in PLANTED(D):
        xT[j, col] = v
    return jp, core.params_from_numpy(jp), xT


def _same_pattern(got, ref):
    """NaN, +inf and -inf at the same places."""
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(got), test(ref))


def _close(got, ref, rtol):
    keep = np.isfinite(ref)
    np.testing.assert_allclose(got[keep], ref[keep], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("student_t", [False, True])
@pytest.mark.parametrize("D", [20, 40, 96, 200])
def test_the_non_finite_values_are_the_xla_paths(D, student_t, dtype):
    """log q of the plain mixture_logpdf_T, fused_logq and fused_rho, and
    rho of fused_rho, against the JAX package's mixture_logpdf_T and
    calculate_rho_rb_T on the XLA path: NaN, +inf and -inf exactly where
    they are there (x_0 = +inf: -inf log q; a later infinite coordinate or
    a NaN: NaN, the zeros above U's diagonal times inf; 1e20: -inf in
    float32, in float64 whatever the XLA path's shift by the largest
    component, a dead one's included, leaves), the finite values close."""
    jp, tp, xT = _problem(D, student_t, dtype)
    ref_lq = np.asarray(jcore.mixture_logpdf_T(jp, jnp.asarray(xT)))
    ref_rho = np.asarray(jpmc.calculate_rho_rb_T(jp, jnp.asarray(xT)))
    assert np.isneginf(ref_lq[1]) and np.isnan(ref_lq[2:5]).all()
    assert np.isneginf(ref_lq[5]) or dtype == np.float64
    assert np.isfinite(ref_lq[np.r_[0, 6:N]]).all()
    x = torch.tensor(xT)
    ops = core._kernel_operands(tp)
    rtol = 1e-10 if dtype == np.float64 else 1e-4
    rho, rho_lq = kernels.fused_rho(x, ops)
    for got in (core.mixture_logpdf_T(tp, x), kernels.fused_logq(x, ops), rho_lq):
        _same_pattern(got.numpy(), ref_lq)
        _close(got.numpy(), ref_lq, rtol)
    for got in (rho.numpy(), pmc.calculate_rho_rb_T(tp, x).numpy()):
        _same_pattern(got, ref_rho)
        _close(got, ref_rho, rtol)


def test_the_packed_u_is_lower_triangular_with_exact_zeros():
    """The packed U (MixtureOperands, L^{-1} by a triangular solve) holds
    exact zeros above its diagonal, so that the tensor-core kernels' split
    of its lower triangle and a full product agree bit for bit on finite
    particles."""
    for D in (20, 40, 96, 200):
        for dtype in (np.float32, np.float64):
            _, tp, _ = _problem(D, True, dtype)
            U = core._kernel_operands(tp).fields()["U"]
            assert bool((torch.triu(U, diagonal=1) == 0).all())
            assert bool((torch.diagonal(U, dim1=1, dim2=2) > 0).all())


def weighted_lse(terms, weights, skip_dead=False, old=False):
    """A float32 mirror of csrc/common.cuh WeightedLse over terms (K, N), k
    ascending: a term of -inf adds nothing (``old``: the rule before, which
    formed exp(-inf - -inf) = NaN while the sum was empty); ``skip_dead``:
    the tiled and tensor-core epilogues leave w_k = 0 out."""
    terms = terms.astype(np.float32)
    m = np.full(terms.shape[1], -np.inf, np.float32)
    s = np.zeros(terms.shape[1], np.float32)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for v, w in zip(terms, np.asarray(weights, np.float32)):
            if skip_dead and w <= 0:
                continue
            live = np.ones_like(v, bool) if old else v != -np.inf
            up = live & (v > m)
            s_up = (s * np.exp(m - v) + w).astype(np.float32)
            s_dn = (np.float64(w) * np.exp(v - m).astype(np.float64) + s).astype(np.float32)
            s = np.where(up, s_up, np.where(live, s_dn, s)).astype(np.float32)
            m = np.where(up, v, m)
        return (np.log(s) + m).astype(np.float32)


def test_the_weighted_lse_mirror_adds_nothing_for_minus_inf():
    """The mirror of WeightedLse against the XLA path's logsumexp (and the
    port's): a -inf first term, an all -inf column (-inf), a -inf among
    finite terms, a NaN (NaN), each as there; the rule before gave NaN for
    the first two.  On finite terms the two rules agree bit for bit."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 30, (5, 8)).astype(np.float32)
    a[0, 1] = -np.inf                  # the first term -inf
    a[:, 2] = -np.inf                  # every term -inf
    a[3, 3] = -np.inf                  # one of them
    a[2, 4] = np.nan
    a[0, 5], a[4, 5] = -np.inf, np.nan
    w = rng.dirichlet(np.ones(5)).astype(np.float32)
    got = weighted_lse(a, w)
    ref = np.asarray(jlse.logsumexp(jnp.asarray(a.T), jnp.asarray(w), axis=-1))
    _same_pattern(got, ref)
    _close(got, ref, 1e-5)
    port = lse.logsumexp(torch.tensor(a.T), torch.tensor(w), axis=-1).numpy()
    _same_pattern(got, port)
    assert np.isneginf(got[2]) and np.isfinite(got[[0, 1, 3, 6, 7]]).all()
    old = weighted_lse(a, w, old=True)
    assert np.isnan(old[[1, 2]]).all()
    finite = rng.normal(0, 30, (7, 64)).astype(np.float32)
    wf = rng.dirichlet(np.ones(7)).astype(np.float32)
    np.testing.assert_array_equal(weighted_lse(finite, wf), weighted_lse(finite, wf, old=True))


def test_the_source_states_the_minus_inf_rule():
    """csrc/common.cuh WeightedLse::add returns on a term of -inf before
    its two branches, and every streaming log-sum-exp of the kernels goes
    through it (no kernel keeps its own running maximum)."""
    src = (CSRC / "common.cuh").read_text()
    body = re.search(r"struct WeightedLse \{(.*?)\n\};", src, re.S).group(1)
    assert body.index("if (v == -INFINITY) return;") < body.index("if (v > m)")
    for path in CSRC.glob("*.cu*"):
        text = path.read_text()
        assert "m = -INFINITY" not in text or path.name == "common.cuh", path.name


def squares(y, D, old=False):
    """A float32 mirror of SquaresEpi::row_end over a row tile of 128 rows
    (y: (128, N) the product's rows, those past D of A = 0): the squares
    summed row by row by FMA; ``old``: every row, as before."""
    part = np.zeros(y.shape[1], np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for r in range(y.shape[0] if old else min(D, y.shape[0])):
            part = (y[r].astype(np.float64) ** 2 + part).astype(np.float32)
    return part


@pytest.mark.parametrize("D", [65, 96, 100, 128])
def test_the_padded_rows_are_left_out_of_the_squares(D):
    """Rows of a row tile past D hold A = 0, so an infinite coordinate
    gives 0 x inf = NaN there: left out, a particle whose every row is
    infinite gets +inf, the FP32 arithmetic's; with every row, NaN (where D
    is not a multiple of 128).  On finite particles the two agree bit for
    bit (the rows past D add +0)."""
    rng = np.random.default_rng(D)
    U = np.zeros((128, D), np.float32)
    U[:D] = np.tril(rng.normal(0, 1, (D, D)))
    x = rng.normal(0, 1, (D, 6)).astype(np.float32)
    x[0, 0] = np.inf
    with np.errstate(invalid="ignore", over="ignore"):
        y = (U.astype(np.float64) @ x.astype(np.float64)).astype(np.float32)
        y[D:, 0] = 0.0 * np.inf      # fmaf(0, inf, s)
    new, old = squares(y, D), squares(y, D, old=True)
    assert np.isposinf(new[0]) and np.isnan(old[0]) == (D < 128)
    np.testing.assert_array_equal(new[1:], old[1:])


def test_a_non_finite_distance_is_recomputed_with_every_entry_of_u():
    """The record kernels' and the products' squared distances read U's
    lower triangle alone: an infinite x_j gives +inf there, where the XLA
    path's zeros above the diagonal give 0 x inf = NaN in the rows above
    j.  The recomputation (every entry read, as ``maha_fp32_body``) gives
    the XLA path's value; x_0 = +inf gives +inf both ways.  The kernels
    recompute a value only where it is not finite."""
    rng = np.random.default_rng(1)
    D = 40
    U = np.tril(rng.normal(0, 1, (D, D)) + 3 * np.eye(D))
    with np.errstate(invalid="ignore", over="ignore"):
        for j, lower, full in ((D // 2, np.inf, np.nan), (0, np.inf, np.inf),
                               (D - 1, np.inf, np.nan)):
            x = rng.normal(0, 1, D)
            x[j] = np.inf
            lower_only = sum(sum(U[i, c] * x[c] for c in range(i + 1)) ** 2 for i in range(D))
            every = sum(sum(U[i, c] * x[c] for c in range(D)) ** 2 for i in range(D))
            np.testing.assert_array_equal([lower_only, every], [lower, full])
    src = (CSRC / "common.cuh").read_text()
    assert "maha_fp32_body(" in (CSRC / "logq.cu").read_text()
    assert "maha_fp32_body(" in (CSRC / "rho.cu").read_text()
    assert re.search(r"for \(int j = 0; j < D; \+\+j\)\s*s = fmaf\(Ak\[i \* D \+ j\]", src)
    tiled = (CSRC / "tiled.cuh").read_text()
    assert "if (n >= N || isfinite(maha)) return maha;" in tiled
