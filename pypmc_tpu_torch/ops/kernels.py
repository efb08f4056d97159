"""The CUDA kernels of the port, each beside its plain PyTorch version.

==================================  ===============================  ==========================
wrapper                             CUDA source                      replaces (Pallas, TPU)
==================================  ===============================  ==========================
:func:`fused_logq`                  ``csrc/logq.cu``                 ``pallas_kernels.py:788``
:func:`fused_rho`                   ``csrc/rho.cu``                  ``pallas_kernels.py:826``
:func:`fused_maha`                  ``csrc/maha.cu``                 ``pallas_kernels.py:858``
:func:`fused_propose_logq`          ``csrc/propose_logq.cu``         ``pallas_kernels.py:924``
:func:`fused_pmc_stats`             ``csrc/pmc_stats.cu``            ``pallas_kernels.py:1150``
:func:`fused_is_pmc_step`           ``csrc/is_pmc_step.cu``          ``pallas_kernels.py:1336``
:func:`fused_vb_estep`              ``csrc/vb_estep.cu``             ``pallas_kernels.py:1493``
:func:`fused_transform`             ``csrc/transform.cu``            ``pallas_kernels.py:1014``
:func:`fused_transform_rng`         ``csrc/transform.cu``            ``pallas_kernels.py:881``
:func:`fused_pmc_stats_blocked`     ``csrc/pmc_stats_blocked.cu``    ``pallas_kernels.py:1779``
:func:`fused_vb_estep_blocked`      ``csrc/vb_estep_blocked.cu``     ``pallas_kernels.py:1889``
:func:`fused_is_pmc_step_blocked`   ``csrc/is_pmc_step_blocked.cu``  ``pallas_kernels.py:2067``
:func:`fused_mcmc_pool`             ``csrc/mcmc_pool.cu``            ``pallas_kernels.py:2293``
:func:`solve_dofs`                  ``csrc/solve_dofs.cu``           the ``lax.fori_loop`` of
                                                                     ``mix_adapt/pmc.py:349``
:func:`draw_proposal_inputs`        ``csrc/draw.cu``                 ``jax.random`` in
                                                                     ``density/core.py:293``
:func:`fused_draw_transform`        ``csrc/draw.cu``                 ``jax.random`` in
                                                                     ``density/core.py:293``
                                                                     and ``:1014``
:func:`fused_draw_transform_rng`    ``csrc/draw.cu``                 ``jax.random`` in
                                                                     ``density/core.py:293``
                                                                     and ``:881``
==================================  ===============================  ==========================

``density.core.propose_T`` takes the JAX package's transform routes
(:func:`proposal_route`); where the route's transform is a record kernel
(D <= 64), its draw and transform are one launch, :func:`fused_draw_transform`
or :func:`fused_draw_transform_rng`, each bit for bit the two launches it
replaces (:func:`draw_proposal_inputs`, then :func:`fused_transform` or
:func:`fused_transform_rng`), which past D = 64 still run.

Dispatch has two gates.  The size gate, :func:`fits`, is asked by every
``"auto"`` dispatcher of the package before it calls a wrapper.  It is the
JAX package's own rule for running its Pallas kernel, so a mixture takes
the dispatcher's unfused tensor path exactly where the JAX package takes
its XLA path, and :func:`gate` counts that route as ``plain:<kernel>``.
The dispatchers of the three single-pass statistics kernels ask
:func:`route`, which also takes the K-blocked variant where the JAX package
elects it (:func:`elects_blocked`).  Each takes the operands (``like=``, a
tensor or its ``(device, dtype)``), as ``use_pallas`` takes its array: on
the card anything but float32 takes the unfused path, where the JAX package
sends it to XLA; on the CPU the decision depends only on the shape.  It
needs no live tensor, so the CPU can make the card's choice.
The device gate, :func:`use_kernel`, sits in each wrapper: a float32 tensor
on CUDA goes to the kernel, a tensor on the CPU to the plain version, and a
CUDA tensor of any other dtype raises ``TypeError`` (:func:`solve_dofs`
and :func:`draw_proposal_inputs` also take float64).  A CUDA tensor never
reaches a plain version through a wrapper, and a shape past the CUDA
kernel's own limits (``_build.limit_reason``), a failed build or a failed
launch raises.  The plain versions (``plain_*``) compute the same
outputs with tensor operations in any dtype; the CPU path of the whole
package runs through them, and on the card the tests and
``chip_smoke.py`` compare the kernels with them.  The random kernels draw
from a Philox stream per particle; their plain versions draw from a
``torch.Generator`` seeded with the same two words, so the two agree in
distribution, not in value.  The kernels of a PMC step's draw take their
two words by value or from a 2-word int64 tensor on their device, read
inside the kernel, so that a CUDA graph replaying the step draws anew from
the words the tensor holds then; so do ``fused_transform_rng`` and
``draw_proposal_inputs``, the draws of ``density.core.propose_T``.
``fused_logq``, ``fused_rho`` and ``fused_maha`` launch through
``torch.library`` operators whose vmap rules fold a batch of particle
blocks into the particle axis: ``torch.func.vmap`` of a per-point target
that reaches them is one launch.

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
:func:`launch_counts` reads them with the ``plain:<kernel>`` routes and,
for the kernels with variants chosen by shape (``fused_mcmc_pool``: a
thread or a warp a chain, ``_build.pool_variant``; ``fused_vb_estep``,
``fused_is_pmc_step`` and ``fused_pmc_stats``: the register pass or the
entry-table pass, ``_build.dense_plan``; the draws ``fused_transform``,
``fused_transform_rng`` and ``fused_propose_logq``: the record, the looped
or the tiled kernel (``fused_transform``'s tiled pair, the others' drawn
products), ``_build.transform_plan``, ``_build.propose_plan``;
``fused_logq``, ``fused_maha`` and ``fused_rho``: the record or the tiled
kernel, ``_build.eval_variant``), each launch's
variant as ``variant:<kernel>=<variant>``.  Each of these wrappers but
``fused_rho`` takes a ``variant=`` that forces another variant where the
shape has it, as the yardstick of the election.
"""

import dataclasses
import functools
import math

import torch

from .. import _rng
from . import _build
from .lse import logsumexp, tiny
from .random import chisquare, student_t_scale

__all__ = ["MixtureOperands", "fits", "refusal", "gate", "elects_blocked", "route",
           "use_kernel", "fused_logq",
           "fused_rho", "fused_maha", "fused_propose_logq", "fused_pmc_stats",
           "fused_is_pmc_step", "fused_vb_estep", "fused_transform",
           "fused_transform_rng", "fused_pmc_stats_blocked", "fused_vb_estep_blocked",
           "fused_is_pmc_step_blocked", "fused_mcmc_pool", "plain_logq", "plain_rho",
           "plain_logq_blocked", "plain_maha", "plain_propose", "plain_propose_logq",
           "plain_pmc_stats", "plain_is_pmc_step", "plain_vb_estep",
           "plain_pmc_stats_blocked", "plain_vb_estep_blocked",
           "plain_is_pmc_step_blocked", "plain_transform", "plain_transform_rng",
           "plain_mcmc_pool", "solve_dofs", "plain_solve_dofs", "draw_proposal_inputs",
           "plain_draw_proposal_inputs", "fused_draw_transform", "fused_draw_transform_rng",
           "plain_draw_transform", "plain_draw_transform_rng", "proposal_route",
           "mcmc_step_chunk",
           "launch_counts", "reset_launch_counts", "add_launch_counts"]


@dataclasses.dataclass(frozen=True)
class MixtureOperands:
    """A mixture packed for the kernels: one flat buffer laid out as
    ``MixLayout`` in ``csrc/common.cuh``::

        mu (K, D) | U = L^{-1} (K, D, D) | log_norm (K) | weights (K) |
        dof (K) | psi = digamma((D + dof) / 2) (K) | L (K, D, D) | cumw (K)

    (``dof`` is 1 and ``psi`` 0 for a Gaussian mixture; ``cumw`` holds the
    tail-sum inverse-CDF thresholds).  Built by
    :func:`pypmc_tpu_torch.density.core._kernel_operands`."""

    packed: torch.Tensor
    K: int
    dim: int
    student_t: bool

    def fields(self):
        """Views of the packed buffer by name."""
        K, D = self.K, self.dim
        sizes = [("mu", (K, D)), ("U", (K, D, D)), ("log_norm", (K,)),
                 ("weights", (K,)), ("dof", (K,)), ("psi", (K,)),
                 ("L", (K, D, D)), ("cumw", (K,))]
        out, off = {}, 0
        for name, shape in sizes:
            size = math.prod(shape)
            out[name] = self.packed[off:off + size].view(shape)
            off += size
        return out


# The JAX package's rules for running a Pallas kernel, by shape, at its
# default VMEM budget (pypmc_tpu/ops/pallas_kernels.py fits_vmem,
# fits_vmem_blocked, prefer_blocked) and the single-pass statistics
# kernels' K*D <= 128 (pypmc_tpu/mix_adapt/pmc.py:227-241, :427-438,
# variational.py:743-750).
_VMEM_BUDGET = 6 * 1024 * 1024
_QUANTUM_EVAL, _QUANTUM_RNG = 128, 1024
_DENSE_KD = 128
_BLOCKED_HBM = 12 * 1024 ** 3
_SINGLE_PASS = ("fused_pmc_stats", "fused_is_pmc_step", "fused_vb_estep")
# the fewest particles for which the JAX package takes its three
# single-pass statistics kernels and their K-blocked twins: the one-pass VB
# E-step (variational.py:743), the PMC update's statistics (pmc.py:223) and
# the whole PMC step against a mixture target (pmc.py:422).  Below it the
# statistics are direct sums over the particles (for VB they repeat exactly
# once the responsibilities settle, where the one-pass statistics are
# un-whitened through the float32 operands)
_MIN_N = 1024


def _pad8(n):
    return (n + 7) // 8 * 8


def _fits_vmem(K, D, quantum):
    return 4 * (3 * _pad8(K * D) + 3 * _pad8(K) + 3 * _pad8(D)) * quantum <= _VMEM_BUDGET


def _fits_vmem_blocked(K, D, quantum):
    kb = 8 if D > 16 else 8 * max(1, 16 // D)
    K_pad = (K + kb - 1) // kb * kb
    if K_pad // kb > 64:
        return False
    fixed = 4 * (K_pad * D * (D + 1) + K_pad * D * kb * D + 8 * _pad8(K_pad))
    per_lane = 4 * (2 * K_pad + 4 * kb + 3 * kb * D + D + 4)
    return fixed + per_lane * quantum <= _VMEM_BUDGET


def mcmc_step_chunk(n_steps, D):
    """The steps the JAX package's pool unrolls per grid step
    (``pallas_kernels.py`` ``mcmc_step_chunk`` at its default cap): the
    largest divisor of ``n_steps`` up to ``min(8, 2048 // D)``.  It sizes
    the VMEM rule of :func:`refusal` only; the CUDA kernel loops over every
    step."""
    cap = min(8, max(1, 2048 // max(1, D)))
    return max(s for s in range(1, min(cap, n_steps) + 1) if n_steps % s == 0)


def _fits_vmem_mcmc(D, Kt, n_steps, student_t):
    sc = mcmc_step_chunk(n_steps, D)
    per_lane = 4 * (D * _pad8(D) + 2 * _pad8(Kt * (D + 1)) + sc * _pad8(D)
                    + _pad8(Kt) + 10 * _pad8(D) + 16)
    return per_lane * (_QUANTUM_RNG if student_t else _QUANTUM_EVAL) <= _VMEM_BUDGET


def _card_dtype(like):
    """The dtype of operands ``like`` (a tensor, or a ``(device, dtype)``
    pair) where they lie on the card, else None: a decision on the CPU does
    not depend on the dtype."""
    if like is None:
        return None
    device, dtype = (like.device, like.dtype) if isinstance(like, torch.Tensor) else like
    return dtype if torch.device(device).type == "cuda" else None


def refusal(kernel, K, D, Kt=0, *, n=None, n_steps=None, student_t=False, like=None):
    """None where the JAX package runs its Pallas kernel for a (K, D)
    mixture (with a Kt-component target), else its rule, named.

    The transform kernels and the single-pass statistics kernels
    (``fused_pmc_stats``, ``fused_is_pmc_step``, ``fused_vb_estep``) also
    take the particle count ``n`` (they run only from 1024 particles; None
    skips that part of the rule).  For
    ``fused_mcmc_pool``, ``K`` is the target's component count, and the
    rule needs the steps of a cycle ``n_steps`` and whether the proposal is
    Student-t.  ``like`` is the operands, a tensor or its ``(device,
    dtype)``, as the JAX package's ``use_pallas`` takes its array
    (``pypmc_tpu/density/core.py:40``): on the card anything but float32
    takes the unfused path, where the JAX package sends it to XLA on any
    backend; on the CPU the decision is the shape's alone."""
    dtype = _card_dtype(like)
    if dtype is not None and dtype != torch.float32:
        return ("%s: %s operands on the card take the unfused path, where the JAX "
                "package sends every array that is not float32 to XLA" % (kernel, dtype))
    if kernel in ("fused_logq", "fused_rho", "fused_maha"):
        ok, rule = _fits_vmem(K, D, _QUANTUM_EVAL), "a VMEM fit at a 128-particle tile"
    elif kernel in ("fused_transform", "fused_transform_rng"):
        quantum = _QUANTUM_RNG if kernel == "fused_transform_rng" else _QUANTUM_EVAL
        ok = _fits_vmem(K, D, quantum) and (n is None or n >= _QUANTUM_RNG)
        rule = "a VMEM fit at a %d-particle tile and n >= 1024 (n=%s)" % (quantum, n)
    elif kernel == "fused_mcmc_pool":
        if n_steps is None:
            raise ValueError("fused_mcmc_pool's rule needs n_steps")
        ok = _fits_vmem_mcmc(D, K, n_steps, student_t)
        rule = ("a VMEM fit of the pool at its minimum chain block (%d steps, "
                "Student-t proposal %s)" % (n_steps, student_t))
    elif kernel == "fused_propose_logq":
        ok, rule = _fits_vmem(K + Kt, D, _QUANTUM_RNG), "a VMEM fit at a 1024-particle tile"
    elif kernel in ("fused_pmc_stats_blocked", "fused_vb_estep_blocked"):
        ok = _fits_vmem_blocked(K, D, _QUANTUM_EVAL)
        rule = "a VMEM fit of the K-blocked kernel at a 128-particle tile"
    elif kernel == "fused_is_pmc_step_blocked":
        ok = _fits_vmem_blocked(K + Kt, D, _QUANTUM_RNG)
        rule = ("a VMEM fit of the K-blocked kernel for K + K_target components at a "
                "1024-particle tile")
    elif kernel in _SINGLE_PASS:
        ok, rule = K * D <= _DENSE_KD, "K*D <= %d" % _DENSE_KD
        if kernel == "fused_is_pmc_step" and ok:
            ok, rule = _fits_vmem(K + Kt, D, _QUANTUM_RNG), "a VMEM fit at a 1024-particle tile"
        if ok and n is not None and n < _MIN_N:
            ok, rule = False, "%s and n >= %d (n=%d)" % (rule, _MIN_N, n)
    else:
        raise ValueError("unknown kernel %r" % kernel)
    if ok:
        return None
    return ("%s: K=%d, K_target=%d, D=%d is past the kernel's rule (%s), where "
            "the JAX package takes its unfused path" % (kernel, K, Kt, D, rule))


def fits(kernel, K, D, Kt=0, **rule) -> bool:
    """Whether the kernel runs for a (K, D) mixture (with a Kt-component
    target): the JAX package's own rule for its Pallas kernel (see
    :func:`refusal`, which also takes ``rule``'s keywords).  A shape that
    passes it but is past the CUDA kernel's own limits
    (``_build.limit_reason``) raises in the wrapper on the card, rather than
    fall back."""
    return refusal(kernel, K, D, Kt, **rule) is None


def elects_blocked(kernel, K, D, N, Kt=0, like=None) -> bool:
    """Whether the JAX package, with the single-pass ``kernel`` out of
    reach (:func:`fits` False), elects its K-blocked variant ``kernel +
    "_blocked"`` for N particles: N >= 1024, the mixture fits that kernel's
    VMEM (:func:`fits`, operands ``like`` as there) and the unfused path's
    (K, N) matrices would crowd 12 GiB."""
    if kernel not in _SINGLE_PASS or N < _MIN_N:
        return False
    return fits(kernel + "_blocked", K, D, Kt, like=like) and 12 * K * N > _BLOCKED_HBM


_plain_routes = {}


def route(kernel, K, D, N, Kt=0, like=None):
    """The route of an ``"auto"`` dispatch of the single-pass statistics
    ``kernel`` for N particles and operands ``like`` (:func:`refusal`):
    ``"dense"`` where it fits (:func:`fits`), ``"blocked"`` where the JAX
    package elects the K-blocked variant (:func:`elects_blocked`), else
    None, the unfused path, counted as the route ``plain:<kernel>`` in
    :func:`launch_counts`."""
    if fits(kernel, K, D, Kt, n=N, like=like):
        return "dense"
    if elects_blocked(kernel, K, D, N, Kt, like):
        return "blocked"
    _plain_routes[kernel] += 1
    return None


def gate(kernel, K, D, Kt=0, **rule) -> bool:
    """The gate of an ``"auto"`` dispatch: :func:`fits` (its ``like=``, the
    operands, sends anything but float32 on the card to the unfused path),
    counting a refusal as the route ``plain:<kernel>`` in
    :func:`launch_counts`."""
    if fits(kernel, K, D, Kt, **rule):
        return True
    _plain_routes[kernel] += 1
    return False


def proposal_route(K, D, n, like=None):
    """The route of ``density.core.propose_T``'s draw of ``n`` particles from
    a (K, D) mixture, operands ``like`` (as :func:`refusal`'s): where the gate
    takes ``fused_transform_rng`` or else ``fused_transform`` (the JAX
    package's routes), ``"fused_draw_transform_rng"`` or
    ``"fused_draw_transform"`` where their plan is the record kernel (D <=
    64: the draw and the transform in one launch), else that transform's
    name (:func:`draw_proposal_inputs`, then the transform: two launches);
    None where the gate refuses both (:func:`draw_proposal_inputs` and the
    tensor transform).  Counts the refusals as :func:`gate` does."""
    if gate("fused_transform_rng", K, D, n=n, like=like):
        route = "fused_transform_rng"
    elif gate("fused_transform", K, D, n=n, like=like):
        route = "fused_transform"
    else:
        return None
    if _build.draw_transform_plan(K, D)[0] == "rec":
        return route.replace("fused_", "fused_draw_", 1)
    return route


def use_kernel(*tensors) -> bool:
    """The device gate: True for float32 tensors on CUDA (the kernel
    runs), False for tensors on the CPU (the plain version runs).  Raises
    ``TypeError`` for a CUDA tensor of another dtype or another device type,
    and ``ValueError`` for tensors on different devices."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("tensors on different devices: %s"
                         % sorted({str(t.device) for t in tensors}))
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise TypeError("no kernels for device type %r" % device.type)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError("the CUDA kernels take float32 tensors, got %s"
                            % t.dtype)
    return True


def _check(t, shape, dtype=torch.float32):
    if tuple(t.shape) != tuple(shape):
        raise ValueError("expected shape %s, got %s" % (tuple(shape), tuple(t.shape)))
    if t.dtype != dtype:
        raise TypeError("expected %s, got %s" % (dtype, t.dtype))
    if not t.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _check_operands(ops: MixtureOperands):
    _check(ops.packed, (_build._full_floats(ops.K, ops.dim),))


def _blocks(device, n, per_sm, threads=_build.THREADS):
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // threads), per_sm * n_sm))


@functools.lru_cache(maxsize=None)
def _eval_per_sm(name, K, D, index, variant=None):
    """Blocks of ``fused_logq``'s (``name`` ``"logq"``), ``fused_rho``'s or
    ``fused_maha``'s kernel for a (K, D) mixture that one SM of CUDA device
    ``index`` holds at once (the library's occupancy of the launcher's
    instantiation and shared memory); ``variant``: fused_logq's or
    fused_maha's kernel (None: the elected one)."""
    with torch.cuda.device(index):
        lib = _build.load()
        per_sm = getattr(lib, "pmc_%s_per_sm" % name)(K, D, _EVAL_VARIANTS.get(variant, -1))
    if per_sm < 1:
        raise RuntimeError("fused_%s: K=%d, D=%d fits no block on an SM" % (name, K, D))
    return per_sm


def _eval_blocks(name, device, n, K, D, variant=None):
    """One wave of ``fused_logq``'s, ``fused_rho``'s or ``fused_maha``'s
    kernel (``variant``: as :func:`_eval_per_sm`'s) for n particles."""
    return _blocks(device, n, _eval_per_sm(name, K, D, device.index, variant),
                   _build.block_particles("fused_" + name, D, variant))


def _table_blocks(kernel, device, n, K, D, Kt=0):
    """Blocks of an entry-table statistics kernel for n particles: as many
    as fit on every SM at once with its tile of ``_build.stats_tile``
    particles (a thread each; an SM holds 2048 threads and 228 KB of shared
    memory, of which each block also reserves 1 KB)."""
    tile = _build.stats_tile(K, D)
    smem = _build._table_bytes(kernel, K, D, Kt)
    per_sm = max(1, min(2048 // tile, 228 * 1024 // (smem + 1024)))
    return _blocks(device, n, per_sm, tile)


@functools.lru_cache(maxsize=None)
def _dense_per_sm(kernel, K, D, Kt, index):
    """Blocks of the register kernel of ``fused_vb_estep``,
    ``fused_is_pmc_step`` or ``fused_pmc_stats`` for (K, D) that one SM of
    CUDA device ``index`` holds at once (the library's occupancy of its
    instantiation and shared memory)."""
    with torch.cuda.device(index):
        lib = _build.load()
        per_sm = (lib.pmc_vb_estep_per_sm(K, D) if kernel == "fused_vb_estep"
                  else lib.pmc_pmc_stats_per_sm(K, D) if kernel == "fused_pmc_stats"
                  else lib.pmc_is_pmc_step_per_sm(K, Kt, D))
    if per_sm < 1:
        raise RuntimeError("%s: K=%d, D=%d fits no block on an SM" % (kernel, K, D))
    return per_sm


_DENSE_VARIANTS = ("table", "reg")   # the launchers' variant codes 0 and 1
# the draws' kernels and the launchers' variant codes (-1: the plan's)
_DRAW_VARIANTS = {"looped": 0, "rec": 1, "tiled": 2}
# fused_logq's, fused_maha's and fused_rho's kernels and the launchers'
# codes (-1: the elected one)
_EVAL_VARIANTS = {"rec": 1, "tiled": 2}


def _variant_names(kernel):
    """The variants of ``kernel`` that :func:`launch_counts` names."""
    if kernel in _build.DRAWS:
        return tuple(_DRAW_VARIANTS)
    if kernel in _build.TILED:
        return tuple(_EVAL_VARIANTS)
    return _DENSE_VARIANTS


def _transform_variants(D):
    """The draws' kernels at D: the record kernel to D = 64, the looped
    kernel to D = 128 and the tiled product (fused_transform's tiled pair,
    the others' drawn products) at any D."""
    return tuple(v for v, top in (("rec", _build._REC_D_MAX), ("looped", _build._THREAD_D_MAX),
                                  ("tiled", _build.WIDE_D_MAX)) if D <= top)


def _elect(kernel, K, D, variant, Kt=0):
    """The variant of ``kernel`` (a draw kernel, a dense statistics kernel,
    ``fused_logq``, ``fused_maha`` or ``fused_rho``) at (K, D): its plan's
    for None (``_build.draw_plan``, ``_build.dense_plan``,
    ``_build.eval_variant``), else ``variant`` where the shape has it -- the
    plan's, or its yardstick (the entry table beside the register pass, the
    tiled kernel beside the record kernel; a draw any of
    :func:`_transform_variants`); ``ValueError`` elsewhere, on any
    device."""
    if kernel in _build.DRAWS:
        elected = _build.draw_plan(kernel, K, D, Kt)[0]
        if variant is None or variant in _transform_variants(D):
            return elected if variant is None else variant
        raise ValueError("%s: no %r variant at K=%d, D=%d (the plan: %s)"
                         % (kernel, variant, K, D, elected))
    if kernel in _build.TILED:
        elected = _build.eval_variant(kernel, D)
        if variant in (None, elected, "tiled"):
            return elected if variant is None else variant
        raise ValueError("%s: no %r variant at K=%d, D=%d (the plan: %s)"
                         % (kernel, variant, K, D, elected))
    elected, other = _build.dense_plan(kernel, K, D, Kt)[0], ("reg", "table")
    if variant is None or variant == elected or (elected, variant) == other:
        return elected if variant is None else variant
    raise ValueError("%s: no %r variant at K=%d, D=%d (the plan: %s)"
                     % (kernel, variant, K, D, elected))


def _dense_blocks(kernel, device, n, K, D, Kt, variant):
    """Blocks of ``fused_vb_estep``, ``fused_is_pmc_step`` or
    ``fused_pmc_stats`` for n particles on the pass ``variant``: the register
    pass's grid is a wave of its blocks over rounds of 128 particles, the
    entry table's that of :func:`_table_blocks`."""
    if variant == "reg":
        return _blocks(device, n, _dense_per_sm(kernel, K, D, Kt, device.index))
    return _table_blocks(kernel, device, n, K, D, Kt)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _seed_args(seed, device):
    """``(s0, s1, words)``, a random kernel's seed arguments: the two words
    of a tuple, passed by value, or the address of a 2-word int64 tensor on
    the kernel's ``device``, read inside the kernel (a CUDA graph replays
    the address, so a replay reads the words the tensor holds then)."""
    if not isinstance(seed, torch.Tensor):
        return seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF, None
    if tuple(seed.shape) != (2,) or seed.dtype != torch.int64 or not seed.is_contiguous():
        raise ValueError("a seed tensor holds two contiguous int64 words, got %s %s"
                         % (seed.dtype, tuple(seed.shape)))
    if seed.device != device:
        raise ValueError("seed words on %s, the kernel on %s" % (seed.device, device))
    return 0, 0, seed.data_ptr()


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (name, err))


def _entries(K, D):
    return K * (3 + D + D * (D + 1) // 2) + 3


def _unpack_stats(flat, K, D, n_sw):
    """The kernels' flat statistics vector (``csrc/stats.cuh``) as the
    dict of :func:`plain_pmc_stats`."""
    P = 3 + D + D * (D + 1) // 2
    per = flat[:K * P].view(K, P)
    rows, cols = torch.tril_indices(D, D, device=flat.device)
    g = flat.new_zeros((K, D, D))
    g[:, rows, cols] = per[:, 3 + D:]
    g[:, cols, rows] = per[:, 3 + D:]
    return {"s0": per[:, 0], "s0c": per[:, 1], "sd": per[:, 3:3 + D], "g": g,
            "sw": flat[K * P:K * P + n_sw], "t1": per[:, 2]}


# --------------------------------------------------------------------- #
# plain versions                                                        #
# --------------------------------------------------------------------- #

def _component_logpdfs_T(xT, f, dim, student_t):
    """``(diff (K, D, N), maha (K, N), ind (K, N))`` with ``diff = U_k (x
    - mu_k)`` and ``ind`` the component log-densities."""
    diff = f["U"] @ (xT[None, :, :] - f["mu"][:, :, None])
    maha = torch.sum(diff * diff, dim=1)
    ln = f["log_norm"][:, None]
    if student_t:
        nu = f["dof"][:, None]
        ind = ln - 0.5 * (nu + dim) * torch.log1p(maha / nu)
    else:
        ind = ln - 0.5 * maha
    return diff, maha, ind


# elements of a (components, D, N) intermediate of a plain K-blocked version
_PLAIN_CHUNK_ELEMENTS = 1 << 26


def _chunks(K, D, N):
    """``(k0, k1)`` ranges over ``[0, K)`` of as many components as keep a
    ``(components, D, N)`` intermediate within ``_PLAIN_CHUNK_ELEMENTS``."""
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, D * N))
    return [(k0, min(K, k0 + chunk)) for k0 in range(0, K, chunk)]


def _slice(f, k0, k1):
    return {name: v[k0:k1] for name, v in f.items()}


def _streaming_logq(xT, ops: MixtureOperands, chunks):
    """The mixture log-density as a weighted log-sum-exp streamed over the
    component ``chunks``; one chunk is the plain log-sum-exp."""
    f = ops.fields()
    out = None
    for k0, k1 in chunks:
        fc = _slice(f, k0, k1)
        _, _, ind = _component_logpdfs_T(xT, fc, ops.dim, ops.student_t)
        part = logsumexp(ind, fc["weights"][:, None], axis=0)
        out = part if out is None else torch.logaddexp(out, part)
    return out


def plain_logq(xT, ops: MixtureOperands):
    """Plain version of :func:`fused_logq`."""
    return _streaming_logq(xT, ops, [(0, ops.K)])


def plain_logq_blocked(xT, ops: MixtureOperands):
    """:func:`plain_logq` streamed over the component chunks of
    :func:`_chunks`: the first pass of the plain K-blocked versions, which
    never forms a (K, N) matrix."""
    return _streaming_logq(xT, ops, _chunks(ops.K, ops.dim, xT.shape[1]))


def _rho_from_logpdfs(ind, wk, log_q=None):
    """Log-space responsibilities ``w_k exp(ind_k - log q)``, exactly 0 for
    a dead component, and ``log q`` (the log-sum-exp of ``ind`` where it is
    not given)."""
    if log_q is None:
        log_q = logsumexp(ind, wk, axis=0)
    rho = torch.where(wk > 0, torch.exp(ind - log_q[None, :]) * wk,
                      torch.zeros_like(ind))
    return rho, log_q


def plain_rho(xT, ops: MixtureOperands):
    """Plain version of :func:`fused_rho`: ``(rho (K, N), log_q (N,))``."""
    f = ops.fields()
    _, _, ind = _component_logpdfs_T(xT, f, ops.dim, ops.student_t)
    return _rho_from_logpdfs(ind, f["weights"][:, None])


def _project(xT, a, m):
    """``a_k (x_n - m_k)``, shape ``(K, D, N)``."""
    return a @ (xT[None, :, :] - m[:, :, None])


def plain_maha(xT, a, m):
    """Plain version of :func:`fused_maha`: ``(K, N)``."""
    diff = _project(xT, a, m)
    return torch.sum(diff * diff, dim=1)


def _plain_vb(xT, w, a, m, const, chunks):
    """The VB E-step statistics over the component ``chunks``: a first
    pass streams the log-sum-exp of the softmax where there is more than
    one chunk, a second forms each chunk's statistics."""
    def log_rho(k0, k1):
        diff = _project(xT, a[k0:k1], m[k0:k1])
        return diff, const[k0:k1, None] - 0.5 * torch.sum(diff * diff, dim=1)

    lse = None
    if len(chunks) > 1:
        for k0, k1 in chunks:
            part = torch.logsumexp(log_rho(k0, k1)[1], dim=0)
            lse = part if lse is None else torch.logaddexp(lse, part)
    parts = []
    for k0, k1 in chunks:
        diff, lr = log_rho(k0, k1)
        log_r = lr - (torch.logsumexp(lr, dim=0) if lse is None else lse)[None, :]
        wr = torch.exp(log_r) * w[None, :]
        cdiff = diff * wr[:, None, :]
        parts.append((wr.sum(1), cdiff.sum(2), cdiff @ diff.transpose(1, 2),
                      torch.sum(wr * log_r)))
    n_comp, sd, g, ent = zip(*parts)
    return torch.cat(n_comp), torch.cat(sd), torch.cat(g), torch.stack(ent).sum()


def plain_vb_estep(xT, w, a, m, const):
    """Plain version of :func:`fused_vb_estep`: ``(N_comp (K,), sd (K, D),
    g (K, D, D), log_q_Z ())``."""
    return _plain_vb(xT, w, a, m, const, [(0, a.shape[0])])


def plain_vb_estep_blocked(xT, w, a, m, const):
    """Plain version of :func:`fused_vb_estep_blocked`: the outputs of
    :func:`plain_vb_estep`, streamed over the component chunks of
    :func:`_chunks`, so no (K, N) matrix is formed."""
    return _plain_vb(xT, w, a, m, const, _chunks(a.shape[0], a.shape[1], xT.shape[1]))


def plain_transform(zT, latent, scale, ops: MixtureOperands):
    """Plain version of :func:`fused_transform`: ``mu[latent] + (L[latent]
    z) * scale``, ``(D, N)``, one component's particles at a time."""
    f = ops.fields()
    xT = torch.empty_like(zT)
    for k in range(ops.K):
        idx = torch.nonzero(latent == k).squeeze(1)
        xT[:, idx] = f["mu"][k][:, None] + (f["L"][k] @ zT[:, idx]) * scale[idx]
    return xT


def _draw_transform(gen, latent, ops: MixtureOperands):
    """Normals and, for Student-t, the scale ``sqrt(dof / chi2(dof))`` from
    ``gen``, transformed for the given components."""
    f = ops.fields()
    n, dtype, device = latent.shape[0], ops.packed.dtype, ops.packed.device
    z = torch.randn((ops.dim, n), generator=gen, dtype=dtype, device=device)
    if ops.student_t:
        scale = student_t_scale(gen, f["dof"][latent.long()], (n,))
    else:
        scale = torch.ones((n,), dtype=dtype, device=device)
    return plain_transform(z, latent, scale, ops)


def plain_transform_rng(seed, latent, ops: MixtureOperands):
    """Plain version of :func:`fused_transform_rng`, drawing from a
    generator seeded with the two ``seed`` words."""
    return _draw_transform(_rng.device_generator(seed, ops.packed.device), latent, ops)


def plain_draw_proposal_inputs(seed, cumw, dof, n: int, D: int, normals: bool):
    """Plain version of :func:`draw_proposal_inputs`: from a generator on
    ``cumw``'s device seeded with the two ``seed`` words, the components
    (one uniform each against the thresholds), then with ``normals`` the
    normals ``zT (D, n)`` and the scales ``(n,)`` (``sqrt(dof /
    max(chi2(dof), tiny))`` for a Student-t mixture, else 1)."""
    gen = _rng.device_generator(seed, cumw.device)
    dtype, device = cumw.dtype, cumw.device
    u = torch.rand(n, generator=gen, dtype=dtype, device=device)
    latent = torch.sum(u[None, :] >= cumw[:-1, None], dim=0, dtype=torch.int32)
    if not normals:
        return latent, None, None
    zT = torch.randn((D, n), generator=gen, dtype=dtype, device=device)
    if dof is None:
        return latent, zT, torch.ones((n,), dtype=dtype, device=device)
    dof_n = dof[latent.long()]
    chi2 = torch.clamp(chisquare(gen, dof_n, (n,)), min=tiny(dtype))
    return latent, zT, torch.sqrt(dof_n / chi2)


def plain_draw_transform(seed, ops: MixtureOperands, n: int):
    """Plain version of :func:`fused_draw_transform`: the two calls it
    replaces, :func:`plain_draw_proposal_inputs` with the normals (the
    mixture's thresholds and, for Student-t, its dofs), then
    :func:`plain_transform` -> ``(xT (D, n), latent (n,) int32)``."""
    f = ops.fields()
    latent, zT, scale = plain_draw_proposal_inputs(
        seed, f["cumw"], f["dof"] if ops.student_t else None, n, ops.dim, True)
    return plain_transform(zT, latent, scale, ops), latent


def plain_draw_transform_rng(seed, ops: MixtureOperands, n: int):
    """Plain version of :func:`fused_draw_transform_rng`: the two calls it
    replaces, :func:`plain_draw_proposal_inputs` without the normals, then
    :func:`plain_transform_rng` keyed by the words with bit 0 of the second
    flipped -> ``(xT (D, n), latent (n,) int32)``."""
    latent = plain_draw_proposal_inputs(seed, ops.fields()["cumw"], None, n, ops.dim, False)[0]
    return plain_transform_rng(_rng.flip_bit(seed, 0), latent, ops), latent


def plain_propose(gen, ops: MixtureOperands, n: int):
    """Draw ``n`` particles from the packed mixture with generator ``gen``
    (on the operands' device): ``(xT (D, n), latent (n,) int32)``.  The
    component comes from one uniform in [0, 1) against the tail-sum
    thresholds, so a dead component is never drawn."""
    f = ops.fields()
    u = torch.rand(n, generator=gen, dtype=ops.packed.dtype, device=ops.packed.device)
    latent = torch.zeros((n,), dtype=torch.int32, device=ops.packed.device)
    for k0, k1 in _chunks(ops.K - 1, 1, n):
        latent += torch.sum(u[None, :] >= f["cumw"][k0:k1, None], dim=0, dtype=torch.int32)
    return _draw_transform(gen, latent, ops), latent


def plain_mcmc_pool(seed, x0T, e0, cholr, dof_prop, target: MixtureOperands,
                    n_steps: int):
    """Plain version of :func:`fused_mcmc_pool`: the same Metropolis steps
    over all chains as tensor code, one step at a time, drawing from a
    generator seeded with the two ``seed`` words."""
    D, C = x0T.shape
    dtype, device = x0T.dtype, x0T.device
    gen = _rng.device_generator(seed, device)
    chols = cholr.to(dtype).reshape(D, D, C)
    x, e = x0T.clone(), e0.to(dtype).clone()
    points = torch.empty((n_steps, D, C), dtype=dtype, device=device)
    accepts = torch.zeros((C,), dtype=torch.int32, device=device)
    nan_counts = torch.zeros_like(accepts)
    dof = None if dof_prop is None else torch.full((C,), float(dof_prop), dtype=dtype,
                                                   device=device)
    for step in range(n_steps):
        z = torch.randn((D, C), generator=gen, dtype=dtype, device=device)
        delta = torch.einsum("dec,ec->dc", chols, z)
        if dof is not None:
            delta = delta * student_t_scale(gen, dof, (C,))
        prop = x + delta
        e_prop = plain_logq(prop, target)
        log_u = torch.log(1.0 - torch.rand((C,), generator=gen, dtype=dtype, device=device))
        log_rho = e_prop - e
        is_nan = torch.isnan(log_rho)
        accept = ~is_nan & (log_rho >= log_u)
        x = torch.where(accept, prop, x)
        e = torch.where(accept, e_prop, e)
        accepts += accept.to(torch.int32)
        nan_counts += is_nan.to(torch.int32)
        points[step] = x
    return points, accepts, nan_counts, x, e


def plain_propose_logq(seed, ops: MixtureOperands, n: int, target=None):
    """Plain version of :func:`fused_propose_logq`."""
    gen = _rng.device_generator(seed, ops.packed.device)
    xT, latent = plain_propose(gen, ops, n)
    log_q = plain_logq(xT, ops)
    if target is None:
        return xT, latent, log_q
    return xT, latent, log_q, plain_logq(xT, target)


def _plain_stats(xT, w, ops: MixtureOperands, dof_stats, n_sw, chunks, log_q=None):
    """The PMC statistics over the component ``chunks``, the
    responsibilities ``w_k exp(ind_k - log q)`` (exactly 0 for a dead
    component); ``log_q`` None takes it from the one chunk's log-densities."""
    f = ops.fields()
    D = ops.dim
    parts = []
    for k0, k1 in chunks:
        fc = _slice(f, k0, k1)
        diff, maha, ind = _component_logpdfs_T(xT, fc, D, ops.student_t)
        rho, log_q = _rho_from_logpdfs(ind, fc["weights"][:, None], log_q)
        wrho = rho * w[None, :]
        if ops.student_t:
            nu = fc["dof"][:, None]
            gamma = (nu + D) / (nu + maha)
            c = wrho * gamma
        else:
            c = wrho
        cdiff = diff * c[:, None, :]
        if dof_stats and ops.student_t:
            brk = torch.log(0.5 * (maha + nu)) - fc["psi"][:, None] + gamma
            t1 = torch.sum(wrho * brk, dim=1)
        else:
            t1 = torch.zeros_like(fc["weights"])
        parts.append({"s0": wrho.sum(1), "s0c": c.sum(1), "sd": cdiff.sum(2),
                      "g": cdiff @ diff.transpose(1, 2), "t1": t1})
    out = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
    # xlogy(w, w) = w log w, and exactly 0 where w == 0
    out["sw"] = torch.stack([w.sum(), (w * w).sum(), torch.special.xlogy(w, w).sum()])[:n_sw]
    return out


def plain_pmc_stats(xT, w, ops: MixtureOperands, dof_stats=False, n_sw=2):
    """Plain version of :func:`fused_pmc_stats`: the dict ``s0, s0c (K,)``,
    ``sd (K, D)``, ``g (K, D, D)``, ``sw (n_sw,)``, ``t1 (K,)``."""
    return _plain_stats(xT, w, ops, dof_stats, n_sw, [(0, ops.K)])


def plain_pmc_stats_blocked(xT, w, ops: MixtureOperands, dof_stats=False, n_sw=2):
    """Plain version of :func:`fused_pmc_stats_blocked`: the outputs of
    :func:`plain_pmc_stats` from a log q streamed over the component chunks
    of :func:`_chunks` and a second pass over the same chunks, so no (K, N)
    matrix is formed."""
    chunks = _chunks(ops.K, ops.dim, xT.shape[1])
    return _plain_stats(xT, w, ops, dof_stats, n_sw, chunks, _streaming_logq(xT, ops, chunks))


def plain_is_pmc_step(seed, ops: MixtureOperands, target: MixtureOperands,
                      n: int, dof_stats=False):
    """Plain version of :func:`fused_is_pmc_step`."""
    xT, latent, log_q, log_p = plain_propose_logq(seed, ops, n, target)
    w = torch.exp(log_p - log_q)
    return xT, latent, w, plain_pmc_stats(xT, w, ops, dof_stats, n_sw=3)


def plain_is_pmc_step_blocked(seed, ops: MixtureOperands, target: MixtureOperands,
                              n: int, dof_stats=False):
    """Plain version of :func:`fused_is_pmc_step_blocked`: the particles of
    :func:`plain_is_pmc_step` from the same seed words, with log q, log p and
    the statistics streamed over component chunks as in
    :func:`plain_pmc_stats_blocked`."""
    xT, latent = plain_propose(_rng.device_generator(seed, ops.packed.device), ops, n)
    chunks = _chunks(ops.K, ops.dim, n)
    log_q = _streaming_logq(xT, ops, chunks)
    w = torch.exp(plain_logq_blocked(xT, target) - log_q)
    return xT, latent, w, _plain_stats(xT, w, ops, dof_stats, 3, chunks, log_q)


def plain_solve_dofs(const, old_dofs, steps, mindof, maxdof):
    """Plain version of :func:`solve_dofs`: the bisection over all K
    components at once, ~13 tensor operations a step."""
    def condition(nu):
        return const + torch.log(0.5 * nu) - torch.special.digamma(0.5 * nu)

    lo = torch.full_like(const, mindof)
    hi = torch.full_like(const, maxdof)
    f_lo, f_hi = condition(lo), condition(hi)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        go_right = condition(mid) > 0     # decreasing: root right of mid
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    root = 0.5 * (lo + hi)
    root = torch.where(f_lo < 0, torch.full_like(root, mindof), root)
    root = torch.where(f_hi > 0, torch.full_like(root, maxdof), root)
    return torch.where(torch.isfinite(root), root, old_dofs)


# --------------------------------------------------------------------- #
# kernel wrappers                                                       #
# --------------------------------------------------------------------- #

def _batch_folded(launch, x_dim, xT, *args):
    """``launch`` (an operator on particles ``xT (D, N)``) over a batch of
    particle blocks at ``x_dim`` of ``xT``, as one launch on ``(D, B N)``:
    its outputs, ``(..., B N)``, as ``(..., B, N)``."""
    x = xT.movedim(x_dim, 1)                # (D, B, N)
    D, B, N = x.shape
    out = launch(x.reshape(D, B * N).contiguous(), *args)
    if isinstance(out, torch.Tensor):
        return out.unflatten(-1, (B, N))
    return tuple(o.unflatten(-1, (B, N)) for o in out)


def fused_logq(xT, ops: MixtureOperands, variant=None):
    """Mixture log-density ``(N,)`` of transposed particles ``xT (D, N)``
    (kernel ``csrc/logq.cu``).  ``torch.func.vmap`` maps it over a batch
    of particle blocks with one launch.  ``variant``: the kernel, ``"rec"``
    (the record kernel, to D = 64) or ``"tiled"`` (the block-tiled product
    kernel, any D), as ``_build.eval_variant`` elects for None; counted as
    ``variant:fused_logq=<variant>``."""
    variant = _elect("fused_logq", ops.K, ops.dim, variant)
    if not use_kernel(xT, ops.packed):
        return plain_logq(xT, ops)
    if xT.shape[0] != ops.dim:
        raise ValueError("expected %d rows, got shape %s" % (ops.dim, tuple(xT.shape)))
    if variant != _build.eval_variant("fused_logq", ops.dim):
        return _logq_run(xT, ops.packed, ops.K, bool(ops.student_t), variant)
    return _logq_launch(xT, ops.packed, ops.K, bool(ops.student_t))


def _logq_run(xT, packed, K, student_t, variant=None):
    """One launch of ``fused_logq``'s kernel ``variant`` (None: the elected
    one) on CUDA tensors."""
    D, N = xT.shape
    variant = variant or _build.eval_variant("fused_logq", D)
    ops = MixtureOperands(packed, K, D, student_t)
    _check(xT, (D, N))
    _check_operands(ops)
    _build.check_limits("fused_logq", K, D)
    lib = _build.load()
    out = torch.empty((N,), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_logq(
            xT.data_ptr(), packed.data_ptr(), out.data_ptr(), N, K, D,
            int(student_t), _EVAL_VARIANTS[variant],
            _eval_blocks("logq", xT.device, N, K, D, variant), _stream(xT.device))
    _raise_on(err, "fused_logq")
    fused_logq.launches += 1
    _variant_counts["fused_logq=" + variant] += 1
    return out


# The launch is an operator so that vmap can map a per-point target that
# reaches it (the samplers vmap per-point targets, as the JAX package vmaps
# its Pallas kernel): its vmap rule folds the batch into the particle axis.
@torch.library.custom_op("pypmc_tpu_torch::fused_logq", mutates_args=(),
                         device_types="cuda")
def _logq_launch(xT: torch.Tensor, packed: torch.Tensor, K: int,
                 student_t: bool) -> torch.Tensor:
    return _logq_run(xT, packed, K, student_t)


def _logq_vmap(info, in_dims, xT, packed, K, student_t):
    x_dim, ops_dim = in_dims[0], in_dims[1]
    if ops_dim is not None:
        raise NotImplementedError("fused_logq maps over particles, not over mixtures")
    if x_dim is None:
        return _logq_launch(xT, packed, K, student_t), None
    return _batch_folded(_logq_launch, x_dim, xT, packed, K, student_t), 0


_logq_launch.register_vmap(_logq_vmap)


def fused_rho(xT, ops: MixtureOperands):
    """Rao-Blackwellized responsibilities ``rho (K, N)`` (exactly 0 for a
    dead component) and the mixture log-density ``(N,)`` of transposed
    particles ``xT (D, N)`` (kernel ``csrc/rho.cu``: the record kernel below
    ``_build.TILED_D_MIN``, the tiled kernel from it, as
    ``_build.eval_variant`` elects; counted as ``variant:fused_rho=<variant>``;
    its log q is :func:`fused_logq`'s bit for bit).  ``torch.func.vmap`` maps
    it over a batch of particle blocks with one launch: ``rho (K, B, N)``,
    ``log_q (B, N)``."""
    if not use_kernel(xT, ops.packed):
        return plain_rho(xT, ops)
    if xT.shape[0] != ops.dim:
        raise ValueError("expected %d rows, got shape %s" % (ops.dim, tuple(xT.shape)))
    return _rho_launch(xT, ops.packed, ops.K, bool(ops.student_t))


@torch.library.custom_op("pypmc_tpu_torch::fused_rho", mutates_args=(),
                         device_types="cuda")
def _rho_launch(xT: torch.Tensor, packed: torch.Tensor, K: int,
                student_t: bool) -> tuple[torch.Tensor, torch.Tensor]:
    D, N = xT.shape
    ops = MixtureOperands(packed, K, D, student_t)
    _check(xT, (D, N))
    _check_operands(ops)
    _build.check_limits("fused_rho", K, D)
    variant = _build.eval_variant("fused_rho", D)
    lib = _build.load()
    rho = torch.empty((K, N), dtype=torch.float32, device=xT.device)
    log_q = torch.empty((N,), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_rho(
            xT.data_ptr(), packed.data_ptr(), rho.data_ptr(), log_q.data_ptr(),
            N, K, D, int(student_t), _EVAL_VARIANTS[variant],
            _eval_blocks("rho", xT.device, N, K, D), _stream(xT.device))
    _raise_on(err, "fused_rho")
    fused_rho.launches += 1
    _variant_counts["fused_rho=" + variant] += 1
    return rho, log_q


def _rho_vmap(info, in_dims, xT, packed, K, student_t):
    x_dim, ops_dim = in_dims[0], in_dims[1]
    if ops_dim is not None:
        raise NotImplementedError("fused_rho maps over particles, not over mixtures")
    if x_dim is None:
        return _rho_launch(xT, packed, K, student_t), (None, None)
    # rho (K, B, N) with the batch at dim 1, log_q (B, N)
    return _batch_folded(_rho_launch, x_dim, xT, packed, K, student_t), (1, 0)


_rho_launch.register_vmap(_rho_vmap)


def _check_projection(xT, a, m):
    """Shapes and dtypes of :func:`fused_maha`'s and
    :func:`fused_vb_estep`'s operands: ``(K, D)`` of ``a (K, D, D)``."""
    D, N = xT.shape
    _check(xT, (D, N))
    K = a.shape[0]
    for t, shape in ((a, (K, D, D)), (m, (K, D))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError("expected float32 of shape %s, got %s %s"
                             % (shape, t.dtype, tuple(t.shape)))
    return K, D


def fused_maha(xT, a, m, variant=None):
    """``(K, N)`` squared norms ``|a_k (x_n - m_k)|^2`` of transposed
    particles ``xT (D, N)`` for GENERAL matrices ``a (K, D, D)`` (lower,
    upper or full) and centers ``m (K, D)`` (kernel ``csrc/maha.cu``).
    ``torch.func.vmap`` maps it over a batch of particle blocks with one
    launch: ``(K, B, N)``.  ``variant``: the kernel, as
    :func:`fused_logq`'s; counted as ``variant:fused_maha=<variant>``.

    The TPU kernel takes ``b_k = a_k m_k`` and a coordinate center; the
    port takes the centers and forms ``x - m_k`` before the product."""
    variant = _elect("fused_maha", a.shape[0], a.shape[-1], variant)
    if not use_kernel(xT, a, m):
        return plain_maha(xT, a, m)
    if xT.shape[0] != a.shape[-1]:
        raise ValueError("expected %d rows, got shape %s" % (a.shape[-1], tuple(xT.shape)))
    if variant != _build.eval_variant("fused_maha", a.shape[-1]):
        return _maha_run(xT, a, m, variant)
    return _maha_launch(xT, a, m)


def _maha_run(xT, a, m, variant=None):
    """One launch of ``fused_maha``'s kernel ``variant`` (None: the elected
    one) on CUDA tensors."""
    K, D = _check_projection(xT, a, m)
    N = xT.shape[1]
    variant = variant or _build.eval_variant("fused_maha", D)
    _build.check_limits("fused_maha", K, D)
    lib = _build.load()
    ops = torch.cat([a.reshape(-1), m.reshape(-1)])
    out = torch.empty((K, N), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_maha(xT.data_ptr(), ops.data_ptr(), out.data_ptr(), N, K, D,
                                 _EVAL_VARIANTS[variant],
                                 _eval_blocks("maha", xT.device, N, K, D, variant),
                                 _stream(xT.device))
    _raise_on(err, "fused_maha")
    fused_maha.launches += 1
    _variant_counts["fused_maha=" + variant] += 1
    return out


@torch.library.custom_op("pypmc_tpu_torch::fused_maha", mutates_args=(),
                         device_types="cuda")
def _maha_launch(xT: torch.Tensor, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _maha_run(xT, a, m)


def _maha_vmap(info, in_dims, xT, a, m):
    x_dim = in_dims[0]
    if in_dims[1] is not None or in_dims[2] is not None:
        raise NotImplementedError("fused_maha maps over particles, not over matrices")
    if x_dim is None:
        return _maha_launch(xT, a, m), None
    return _batch_folded(_maha_launch, x_dim, xT, a, m), 1    # (K, B, N)


_maha_launch.register_vmap(_maha_vmap)


def fused_vb_estep(xT, w, a, m, const, variant=None):
    """The sufficient statistics of one VB Gaussian-mixture E-step in one
    pass (kernel ``csrc/vb_estep.cu``): responsibilities ``r_k`` are the
    softmax over k of ``const_k - |a_k (x - m_k)|^2 / 2``, and the returns
    are ``N_comp = sum w r (K,)``, the whitened ``sd = sum w r diff
    (K, D)`` and ``g = sum w r diff diff^T (K, D, D)`` with ``diff = a_k
    (x - m_k)``, and ``log_q_Z = sum w sum_k r log r ()``.  ``a`` is
    ``(K, D, D)`` upper triangular, as the VB E-step passes it: the
    register pass reads only the upper triangle.  The kernel's statistics
    are float64.  ``variant``: the kernel's pass, ``"reg"`` or ``"table"``
    (``_build.dense_plan``; None: the plan's), counted as
    ``variant:fused_vb_estep=<variant>``."""
    variant = _elect("fused_vb_estep", a.shape[0], a.shape[-1], variant)
    if not use_kernel(xT, w, a, m, const):
        return plain_vb_estep(xT, w, a, m, const)
    K, D = _check_projection(xT, a, m)
    N = xT.shape[1]
    _check(w, (N,))
    if tuple(const.shape) != (K,):
        raise ValueError("expected const of shape %s, got %s" % ((K,), tuple(const.shape)))
    _build.check_limits("fused_vb_estep", K, D)
    lib = _build.load()
    ops = torch.cat([a.reshape(-1), m.reshape(-1), const])
    S = _entries(K, D)
    n_blocks = _dense_blocks("fused_vb_estep", xT.device, N, K, D, 0, variant)
    partial = torch.empty((n_blocks, S), dtype=torch.float64, device=xT.device)
    flat = torch.empty((S,), dtype=torch.float64, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_vb_estep(
            xT.data_ptr(), w.data_ptr(), ops.data_ptr(), partial.data_ptr(),
            flat.data_ptr(), N, K, D, _DENSE_VARIANTS.index(variant), n_blocks,
            _stream(xT.device))
    _raise_on(err, "fused_vb_estep")
    fused_vb_estep.launches += 1
    _variant_counts["fused_vb_estep=" + variant] += 1
    stats = _unpack_stats(flat, K, D, 0)
    return stats["s0"], stats["sd"], stats["g"], stats["t1"].sum()


def fused_propose_logq(seed, ops: MixtureOperands, n: int, target=None, variant=None):
    """Draw ``n`` particles and evaluate the proposal (and optionally a
    mixture target) on them: ``(xT (D, n), latent (n,) int32, log_q (n,))``
    plus ``log_p (n,)`` with a target (kernel ``csrc/propose_logq.cu``).
    ``seed`` is two 32-bit words: a tuple, or a 2-word int64 tensor on the
    mixture's device (read inside the kernel).  ``variant``: the kernel,
    ``"rec"`` (the record kernel, to D = 64), ``"looped"`` (to D = 128) or
    ``"tiled"`` (any D: the components bucketed, a block-tiled product on
    normals drawn in shared memory, then ``fused_logq``'s tiled kernel for
    log q and log p), as ``_build.propose_plan`` elects for None; each draws
    the same x and latent bit for bit, and the first two the same log q and
    log p.  Counted as ``variant:fused_propose_logq=<variant>``, one launch
    a call."""
    Kt = 0 if target is None else target.K
    variant = _elect("fused_propose_logq", ops.K, ops.dim, variant, Kt)
    tensors = [ops.packed] + ([] if target is None else [target.packed])
    if not use_kernel(*tensors):
        return plain_propose_logq(seed, ops, n, target)
    _check_operands(ops)
    if target is not None:
        _check_operands(target)
        if target.dim != ops.dim:
            raise ValueError("target dimension %d != proposal dimension %d"
                             % (target.dim, ops.dim))
    D, device = ops.dim, ops.packed.device
    _build.check_limits("fused_propose_logq", ops.K, D, Kt)
    lib = _build.load()
    xT = torch.empty((D, n), dtype=torch.float32, device=device)
    latent = torch.empty((n,), dtype=torch.int32, device=device)
    log_q = torch.empty((n,), dtype=torch.float32, device=device)
    log_p = None if target is None else torch.empty_like(log_q)
    scratch = _draw_scratch("fused_propose_logq", variant, n, ops.K, device)
    eval_blocks = _eval_blocks("logq", device, n, ops.K, D, "tiled") if variant == "tiled" else 0
    with torch.cuda.device(device):
        err = lib.pmc_fused_propose_logq(
            *_seed_args(seed, device), ops.packed.data_ptr(),
            None if target is None else target.packed.data_ptr(),
            xT.data_ptr(), latent.data_ptr(), log_q.data_ptr(),
            None if log_p is None else log_p.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, ops.K, Kt, D,
            int(ops.student_t), int(target is not None and target.student_t),
            _DRAW_VARIANTS[variant],
            _draw_blocks("fused_propose_logq", device, n, ops.K, D, variant, Kt), eval_blocks,
            _stream(device))
    _raise_on(err, "fused_propose_logq")
    fused_propose_logq.launches += 1
    _variant_counts["fused_propose_logq=" + variant] += 1
    if target is None:
        return xT, latent, log_q
    return xT, latent, log_q, log_p


def fused_pmc_stats(xT, w, ops: MixtureOperands, dof_stats=False, variant=None):
    """Every sufficient statistic of one PMC update in one pass over
    weighted particles (kernel ``csrc/pmc_stats.cu``); the dict of
    :func:`plain_pmc_stats` with ``sw (2,) = [sum w, sum w^2]``.
    ``variant``: the kernel's pass, ``"reg"`` or ``"table"``
    (``_build.dense_plan``; None: the plan's), counted as
    ``variant:fused_pmc_stats=<variant>``."""
    variant = _elect("fused_pmc_stats", ops.K, ops.dim, variant)
    if not use_kernel(xT, w, ops.packed):
        return plain_pmc_stats(xT, w, ops, dof_stats)
    D, N = xT.shape
    _check(xT, (ops.dim, N))
    _check(w, (N,))
    _check_operands(ops)
    _build.check_limits("fused_pmc_stats", ops.K, D)
    lib = _build.load()
    S = _entries(ops.K, D)
    n_blocks = _dense_blocks("fused_pmc_stats", xT.device, N, ops.K, D, 0, variant)
    partial = torch.empty((n_blocks, S), dtype=torch.float64, device=xT.device)
    flat = torch.empty((S,), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_pmc_stats(
            xT.data_ptr(), w.data_ptr(), ops.packed.data_ptr(),
            partial.data_ptr(), flat.data_ptr(), N, ops.K, D,
            int(ops.student_t), int(dof_stats), _DENSE_VARIANTS.index(variant), n_blocks,
            _stream(xT.device))
    _raise_on(err, "fused_pmc_stats")
    fused_pmc_stats.launches += 1
    _variant_counts["fused_pmc_stats=" + variant] += 1
    return _unpack_stats(flat, ops.K, D, 2)


def fused_is_pmc_step(seed, ops: MixtureOperands, target: MixtureOperands,
                      n: int, dof_stats=False, variant=None):
    """The particle work of one PMC step against a mixture target in one
    pass (kernel ``csrc/is_pmc_step.cu``): ``(xT (D, n), latent (n,),
    w (n,), stats)`` with ``stats`` as :func:`fused_pmc_stats` except
    ``sw (3,) = [sum w, sum w^2, sum w log w]``.  ``variant``: the
    kernel's pass, ``"reg"`` or ``"table"`` (``_build.dense_plan``; None:
    the plan's), counted as ``variant:fused_is_pmc_step=<variant>``; both
    draw the same particles from a seed (and, for a Gaussian target, the
    same weights).  ``seed``: as :func:`fused_propose_logq`'s."""
    variant = _elect("fused_is_pmc_step", ops.K, ops.dim, variant, target.K)
    if not use_kernel(ops.packed, target.packed):
        return plain_is_pmc_step(seed, ops, target, n, dof_stats)
    _check_operands(ops)
    _check_operands(target)
    if target.dim != ops.dim:
        raise ValueError("target dimension %d != proposal dimension %d"
                         % (target.dim, ops.dim))
    D, device = ops.dim, ops.packed.device
    _build.check_limits("fused_is_pmc_step", ops.K, D, target.K)
    lib = _build.load()
    S = _entries(ops.K, D)
    n_blocks = _dense_blocks("fused_is_pmc_step", device, n, ops.K, D, target.K, variant)
    xT = torch.empty((D, n), dtype=torch.float32, device=device)
    latent = torch.empty((n,), dtype=torch.int32, device=device)
    w = torch.empty((n,), dtype=torch.float32, device=device)
    partial = torch.empty((n_blocks, S), dtype=torch.float64, device=device)
    flat = torch.empty((S,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.pmc_fused_is_pmc_step(
            *_seed_args(seed, device), ops.packed.data_ptr(),
            target.packed.data_ptr(), xT.data_ptr(), latent.data_ptr(),
            w.data_ptr(), partial.data_ptr(), flat.data_ptr(), n, ops.K,
            target.K, D, int(ops.student_t), int(target.student_t),
            int(dof_stats), _DENSE_VARIANTS.index(variant), n_blocks, _stream(device))
    _raise_on(err, "fused_is_pmc_step")
    fused_is_pmc_step.launches += 1
    _variant_counts["fused_is_pmc_step=" + variant] += 1
    return xT, latent, w, _unpack_stats(flat, ops.K, D, 3)


_PMC_FIELDS = ("mu", "U", "log_norm", "weights", "dof", "psi")


@functools.lru_cache(maxsize=None)
def _blocked_per_sm(kernel, K, D, index):
    """Blocks of a K-blocked kernel's statistics pass for (K, D) that one SM
    of CUDA device ``index`` holds at once (the library's occupancy, asked
    once: a step captured as a CUDA graph asks the host nothing)."""
    with torch.cuda.device(index):
        per_sm = getattr(_build.load(), "pmc_%s_per_sm" % kernel[len("fused_"):])(K, D)
    if per_sm < 1:
        raise RuntimeError("%s: K=%d, D=%d fits no block of its statistics pass on an SM"
                           % (kernel, K, D))
    return per_sm


def _blocked_operands(kernel, device, n, fields):
    """``(kc, particle blocks, chunk-major operands)`` of a K-blocked
    kernel's statistics pass (``csrc/blocked.cuh``): chunks of ``kc``
    components (``_build.blocked_plan``), each the slices of the ``(K, ...)``
    ``fields`` in turn, and as many particle blocks as let every chunk's
    blocks fit on the card at once (the kernel's occupancy,
    :func:`_blocked_per_sm`)."""
    K, D = fields[0].shape[:2]
    kc = _build.blocked_plan(kernel, K, D)[0]
    per_sm = _blocked_per_sm(kernel, K, D, device.index)
    n_blocks = max(1, _blocks(device, n, per_sm) // -(-K // kc))
    chunks = torch.cat([t[k0:k0 + kc].reshape(-1) for k0 in range(0, K, kc) for t in fields])
    return kc, n_blocks, chunks


def fused_pmc_stats_blocked(xT, w, ops: MixtureOperands, dof_stats=False):
    """:func:`fused_pmc_stats` for mixtures past its one tile (kernel
    ``csrc/pmc_stats_blocked.cu``): log q in a first launch, then the
    statistics chunk by chunk of components; the same dict."""
    if not use_kernel(xT, w, ops.packed):
        return plain_pmc_stats_blocked(xT, w, ops, dof_stats)
    D, N = xT.shape
    _check(xT, (ops.dim, N))
    _check(w, (N,))
    _check_operands(ops)
    _build.check_limits("fused_pmc_stats_blocked", ops.K, D)
    lib = _build.load()
    f = ops.fields()
    kc, n_blocks, chunks = _blocked_operands("fused_pmc_stats_blocked", xT.device, N,
                                             [f[name] for name in _PMC_FIELDS])
    S = _entries(ops.K, D)
    log_q = torch.empty((N,), dtype=torch.float32, device=xT.device)
    partial = torch.empty((n_blocks, S), dtype=torch.float64, device=xT.device)
    flat = torch.empty((S,), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_pmc_stats_blocked(
            xT.data_ptr(), w.data_ptr(), ops.packed.data_ptr(), chunks.data_ptr(),
            log_q.data_ptr(), partial.data_ptr(), flat.data_ptr(), N, ops.K, D, kc,
            int(ops.student_t), int(dof_stats),
            _eval_blocks("logq", xT.device, N, ops.K, D), n_blocks, _stream(xT.device))
    _raise_on(err, "fused_pmc_stats_blocked")
    fused_pmc_stats_blocked.launches += 1
    return _unpack_stats(flat, ops.K, D, 2)


def fused_vb_estep_blocked(xT, w, a, m, const):
    """:func:`fused_vb_estep` for mixtures past its one tile (kernel
    ``csrc/vb_estep_blocked.cu``): the softmax's log-sum-exp in a first
    launch, then the statistics chunk by chunk of components; the same
    returns."""
    if not use_kernel(xT, w, a, m, const):
        return plain_vb_estep_blocked(xT, w, a, m, const)
    K, D = _check_projection(xT, a, m)
    N = xT.shape[1]
    _check(w, (N,))
    if tuple(const.shape) != (K,):
        raise ValueError("expected const of shape %s, got %s" % ((K,), tuple(const.shape)))
    _build.check_limits("fused_vb_estep_blocked", K, D)
    lib = _build.load()
    ops = torch.cat([a.reshape(-1), m.reshape(-1), const])
    kc, n_blocks, chunks = _blocked_operands("fused_vb_estep_blocked", xT.device, N,
                                             [a, m, const])
    S = _entries(K, D)
    lse = torch.empty((N,), dtype=torch.float32, device=xT.device)
    partial = torch.empty((n_blocks, S), dtype=torch.float64, device=xT.device)
    flat = torch.empty((S,), dtype=torch.float64, device=xT.device)
    with torch.cuda.device(xT.device):
        err = lib.pmc_fused_vb_estep_blocked(
            xT.data_ptr(), w.data_ptr(), ops.data_ptr(), chunks.data_ptr(), lse.data_ptr(),
            partial.data_ptr(), flat.data_ptr(), N, K, D, kc, _blocks(xT.device, N, 16),
            n_blocks, _stream(xT.device))
    _raise_on(err, "fused_vb_estep_blocked")
    fused_vb_estep_blocked.launches += 1
    stats = _unpack_stats(flat, K, D, 0)
    return stats["s0"], stats["sd"], stats["g"], stats["t1"].sum()


def fused_is_pmc_step_blocked(seed, ops: MixtureOperands, target: MixtureOperands,
                              n: int, dof_stats=False):
    """:func:`fused_is_pmc_step` for mixtures past its one tile (kernel
    ``csrc/is_pmc_step_blocked.cu``): the draw with log q and log p in a
    first launch -- the particles of :func:`fused_is_pmc_step` from the same
    seed words --, then the weights and the statistics chunk by chunk of
    components; the same returns.  ``seed``: as :func:`fused_propose_logq`'s."""
    if not use_kernel(ops.packed, target.packed):
        return plain_is_pmc_step_blocked(seed, ops, target, n, dof_stats)
    _check_operands(ops)
    _check_operands(target)
    if target.dim != ops.dim:
        raise ValueError("target dimension %d != proposal dimension %d"
                         % (target.dim, ops.dim))
    D, device = ops.dim, ops.packed.device
    _build.check_limits("fused_is_pmc_step_blocked", ops.K, D, target.K)
    lib = _build.load()
    f = ops.fields()
    kc, n_blocks, chunks = _blocked_operands("fused_is_pmc_step_blocked", device, n,
                                             [f[name] for name in _PMC_FIELDS])
    S = _entries(ops.K, D)
    xT = torch.empty((D, n), dtype=torch.float32, device=device)
    latent = torch.empty((n,), dtype=torch.int32, device=device)
    w, log_q, log_p = (torch.empty((n,), dtype=torch.float32, device=device)
                       for _ in range(3))
    partial = torch.empty((n_blocks, S), dtype=torch.float64, device=device)
    flat = torch.empty((S,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.pmc_fused_is_pmc_step_blocked(
            *_seed_args(seed, device), ops.packed.data_ptr(),
            target.packed.data_ptr(), chunks.data_ptr(), xT.data_ptr(), latent.data_ptr(),
            w.data_ptr(), log_q.data_ptr(), log_p.data_ptr(), partial.data_ptr(),
            flat.data_ptr(), n, ops.K, target.K, D, kc, int(ops.student_t),
            int(target.student_t), int(dof_stats), n_blocks, _stream(device))
    _raise_on(err, "fused_is_pmc_step_blocked")
    fused_is_pmc_step_blocked.launches += 1
    return xT, latent, w, _unpack_stats(flat, ops.K, D, 3)


def _transform_operands(ops: MixtureOperands):
    """``mu (K, D) | L (K, D, D) | dof (K)``, the operand buffer of
    ``csrc/transform.cu``."""
    f = ops.fields()
    return torch.cat([f["mu"].reshape(-1), f["L"].reshape(-1), f["dof"]])


@functools.lru_cache(maxsize=None)
def _rec_per_sm(kernel, K, D, Kt, index):
    """Blocks of a draw kernel's record kernel for (K, D) (and a Kt-component
    target) that one SM of CUDA device ``index`` holds at once (the library's
    occupancy of its instantiation and shared memory); the fused draws'
    kernel (``fused_draw_transform``, ``fused_draw_transform_rng``) too."""
    with torch.cuda.device(index):
        lib = _build.load()
        rng = int(kernel.endswith("_rng"))
        per_sm = (lib.pmc_propose_per_sm(K, Kt, D) if kernel == "fused_propose_logq"
                  else lib.pmc_draw_transform_per_sm(K, D, rng)
                  if kernel.startswith("fused_draw_") else lib.pmc_transform_per_sm(K, D, rng))
    if per_sm < 1:
        raise RuntimeError("%s: K=%d, D=%d fits no block on an SM" % (kernel, K, D))
    return per_sm


@functools.lru_cache(maxsize=None)
def _tiled_per_sm(kernel, D, index):
    """Blocks of a draw's tiled product (fused_transform's tiled kernel, the
    same at every shape; fused_transform_rng's and fused_propose_logq's
    drawn product, whose shared memory grows past D = 128) that one SM of
    CUDA device ``index`` holds at once."""
    with torch.cuda.device(index):
        lib = _build.load()
        per_sm = (lib.pmc_transform_tiled_per_sm() if kernel == "fused_transform"
                  else lib.pmc_draw_tiled_per_sm(D))
    if per_sm < 1:
        raise RuntimeError("%s: the tiled kernel fits no block on an SM at D=%d" % (kernel, D))
    return per_sm


def _draw_blocks(kernel, device, n, K, D, variant, Kt=0):
    """One wave of a draw kernel's ``variant`` for n particles: the record
    kernel's from its occupancy, a tiled product's over the slots of its
    tiles (``_build.transform_slots``; a drawn product at K = 1 over tiles
    of 128 particles in order), else 16 blocks an SM of the looped kernel's
    128 threads."""
    if variant == "rec":
        return _blocks(device, n, _rec_per_sm(kernel, K, D, Kt, device.index),
                       _build.EVAL_THREADS)
    if variant == "tiled":
        tiles = (-(-n // _build.tiled_plan()[0]) if K == 1 and kernel != "fused_transform"
                 else _build.transform_slots(n, K))
        return _blocks(device, tiles, _tiled_per_sm(kernel, D, device.index), 1)
    return _blocks(device, n, 16, _build.block_particles(kernel, D, variant))


def _draw_scratch(kernel, variant, n, K, device):
    """The int32 scratch of a tiled product's bucket kernel (perm and slots,
    ``_build.transform_scratch_words``), or None where the launch has no
    bucket kernel (another variant; a drawn product at K = 1)."""
    if variant != "tiled" or (K == 1 and kernel != "fused_transform"):
        return None
    return torch.empty((_build.transform_scratch_words(n, K),), dtype=torch.int32, device=device)


def fused_transform(zT, latent, scale, ops: MixtureOperands, variant=None):
    """The mixture transform ``mu[latent] + (L[latent] z) * scale`` of
    given normals ``zT (D, N)``, components ``latent (N,) int32`` (in [0,
    K)) and scales ``(N,)`` -> ``(D, N)`` (kernel ``csrc/transform.cu``).
    ``variant``: the kernel, ``"rec"`` (the record kernel, to D = 64),
    ``"looped"`` (to D = 128) or ``"tiled"`` (the tiled pair, any D: a
    counting sort of the particles by component, then a block-tiled product
    over tiles of one component's particles), as ``_build.transform_plan``
    elects for None; each gives the same output bit for bit where it runs
    (up to the sign of a zero).  Counted as
    ``variant:fused_transform=<variant>``.  The latents are in [0, K)."""
    variant = _elect("fused_transform", ops.K, ops.dim, variant)
    if not use_kernel(zT, scale, ops.packed):
        return plain_transform(zT, latent, scale, ops)
    D, N = zT.shape
    _check(zT, (ops.dim, N))
    _check(scale, (N,))
    _check(latent, (N,), torch.int32)
    _check_operands(ops)
    _build.check_limits("fused_transform", ops.K, D)
    n_blocks = _draw_blocks("fused_transform", zT.device, N, ops.K, D, variant)
    lib = _build.load()
    operands = _transform_operands(ops)
    xT = torch.empty_like(zT)
    scratch = _draw_scratch("fused_transform", variant, N, ops.K, zT.device)
    with torch.cuda.device(zT.device):
        err = lib.pmc_fused_transform(
            zT.data_ptr(), latent.data_ptr(), scale.data_ptr(), operands.data_ptr(),
            None if scratch is None else scratch.data_ptr(), xT.data_ptr(), N, ops.K, D,
            _DRAW_VARIANTS[variant], n_blocks, _stream(zT.device))
    _raise_on(err, "fused_transform")
    fused_transform.launches += 1
    _variant_counts["fused_transform=" + variant] += 1
    return xT


def _transform_buckets(latent, K):
    """``(perm, slots)`` of fused_transform's bucket kernel alone for the
    components ``latent`` (``(N,)`` int32 on the card; ``slots`` as (n, 4)),
    to be held to ``_build.transform_tiles``; not counted as a launch."""
    N = latent.shape[0]
    _check(latent, (N,), torch.int32)
    scratch = torch.empty((_build.transform_scratch_words(N, K),), dtype=torch.int32,
                          device=latent.device)
    with torch.cuda.device(latent.device):
        err = _build.load().pmc_transform_buckets(latent.data_ptr(), scratch.data_ptr(), N, K,
                                                   _stream(latent.device))
    _raise_on(err, "fused_transform's bucket kernel")
    words = -(-N // 4) * 4
    return scratch[:N], scratch[words:].view(-1, 4)


def fused_transform_rng(seed, latent, ops: MixtureOperands, variant=None):
    """The mixture transform of :func:`fused_transform` with the normals
    and, for a Student-t mixture, the scale ``sqrt(dof / chi2(dof))`` drawn
    in the kernel from a Philox stream per particle keyed by the two
    ``seed`` words (kernel ``csrc/transform.cu``) -> ``(D, N)``.  ``seed``:
    as :func:`fused_propose_logq`'s.  ``variant``: the kernel, as
    :func:`fused_transform`'s (``_build.transform_plan`` with ``rng``;
    ``"tiled"`` the drawn product, its normals drawn in shared memory, after
    the bucket kernel where K > 1), each the same output bit for bit;
    counted as ``variant:fused_transform_rng=<variant>``."""
    variant = _elect("fused_transform_rng", ops.K, ops.dim, variant)
    if not use_kernel(ops.packed):
        return plain_transform_rng(seed, latent, ops)
    N, D, device = latent.shape[0], ops.dim, ops.packed.device
    _check(latent, (N,), torch.int32)
    _check_operands(ops)
    if latent.device != device:
        raise ValueError("latent on %s, the mixture on %s" % (latent.device, device))
    _build.check_limits("fused_transform_rng", ops.K, D)
    lib = _build.load()
    operands = _transform_operands(ops)
    xT = torch.empty((D, N), dtype=torch.float32, device=device)
    scratch = _draw_scratch("fused_transform_rng", variant, N, ops.K, device)
    with torch.cuda.device(device):
        err = lib.pmc_fused_transform_rng(
            *_seed_args(seed, device), latent.data_ptr(), operands.data_ptr(),
            None if scratch is None else scratch.data_ptr(), xT.data_ptr(), N, ops.K, D,
            int(ops.student_t),
            _DRAW_VARIANTS[variant],
            _draw_blocks("fused_transform_rng", device, N, ops.K, D, variant), _stream(device))
    _raise_on(err, "fused_transform_rng")
    fused_transform_rng.launches += 1
    _variant_counts["fused_transform_rng=" + variant] += 1
    return xT


_POOL_VARIANTS = ("thread", "warp")   # csrc/mcmc_pool.cu's variant codes 0 and 1


def fused_mcmc_pool(seed, x0T, e0, cholr, dof_prop, target: MixtureOperands,
                    n_steps: int, variant=None):
    """Run ``C`` symmetric-proposal Metropolis chains for ``n_steps`` steps
    against a mixture target in one launch (kernel ``csrc/mcmc_pool.cu``).

    :param seed: two 32-bit words; chain c's step s draws from the Philox
        stream (seed, c, s).
    :param x0T: ``(D, C)`` starting points; ``e0 (C,)`` the target's
        log-density there.
    :param cholr: ``(D*D, C)`` lower Cholesky factors of the proposals,
        ``cholr[d*D + e, c] = L_c[d, e]`` (entries above the diagonal are not
        read); cast to the chains' dtype.
    :param dof_prop: scalar Student-t proposal dof, or None for Gaussian.
    :param variant: the kernel's variant, ``"thread"`` (a thread a chain) or
        ``"warp"`` (a warp a chain, D <= 64); None takes the one
        ``_build.pool_variant`` elects for (C, D).  Both draw the same
        stream; each launch counts as ``variant:fused_mcmc_pool=<variant>``.
    :returns: ``(points (n_steps, D, C), accepts (C,) int32, nan_counts
        (C,) int32, xfT (D, C), ef (C,))``: the point after each step, the
        accepted and the NaN proposals (always rejected) per chain, and the
        final state.
    """
    cholr = cholr.to(x0T.dtype)
    if not use_kernel(x0T, e0, cholr, target.packed):
        return plain_mcmc_pool(seed, x0T, e0, cholr, dof_prop, target, n_steps)
    D, C = x0T.shape
    _check(x0T, (target.dim, C))
    _check(e0, (C,))
    cholr = cholr.contiguous()
    _check(cholr, (D * D, C))
    _check_operands(target)
    _build.check_limits("fused_mcmc_pool", target.K, D)
    variant = _build.pool_variant(C, D) if variant is None else variant
    if variant not in _POOL_VARIANTS or (variant == "warp" and D > _build._POOL_WARP_D_MAX):
        raise ValueError("fused_mcmc_pool: no variant %r at D=%d" % (variant, D))
    lib = _build.load()
    device = x0T.device
    points = torch.empty((n_steps, D, C), dtype=torch.float32, device=device)
    accepts = torch.empty((C,), dtype=torch.int32, device=device)
    nan_counts = torch.empty_like(accepts)
    xfT = torch.empty_like(x0T)
    ef = torch.empty_like(e0)
    with torch.cuda.device(device):
        err = lib.pmc_fused_mcmc_pool(
            seed[0] & 0xFFFFFFFF, seed[1] & 0xFFFFFFFF, x0T.data_ptr(), e0.data_ptr(),
            cholr.data_ptr(), 1.0 if dof_prop is None else float(dof_prop),
            target.packed.data_ptr(), points.data_ptr(), accepts.data_ptr(),
            nan_counts.data_ptr(), xfT.data_ptr(), ef.data_ptr(), C, int(n_steps),
            target.K, D, int(dof_prop is not None), int(target.student_t),
            _POOL_VARIANTS.index(variant), _stream(device))
    _raise_on(err, "fused_mcmc_pool")
    fused_mcmc_pool.launches += 1
    _variant_counts["fused_mcmc_pool=" + variant] += 1
    return points, accepts, nan_counts, xfT, ef


_DOF_VARIANTS = ("serial", "warp")   # csrc/solve_dofs.cu's variant codes 0 and 1


def solve_dofs(const, old_dofs, steps, mindof, maxdof, variant="warp"):
    """The [HOD12] eq. (16) Student-t dof update of K components: the
    root in nu of ``const_k + log(nu / 2) - digamma(nu / 2)`` (decreasing
    in nu) by ``steps`` bisection steps on ``[mindof, maxdof]``, clamped to
    an end where the bracket holds no sign change, the old dof where the
    root is not finite (a NaN ``const`` falls to ``mindof``), in one launch
    of kernel ``csrc/solve_dofs.cu`` (float32 or float64).  ``variant``:
    ``"warp"`` (a warp a component, five levels of the bisection a round)
    or ``"serial"`` (a thread a component, a step at a time); both give the
    plain version's roots bit for bit.  Counted as
    ``variant:solve_dofs=<variant>``."""
    if variant not in _DOF_VARIANTS:
        raise ValueError("solve_dofs: no variant %r (%s)" % (variant, _DOF_VARIANTS))
    if const.device != old_dofs.device:
        raise ValueError("tensors on different devices: %s, %s"
                         % (const.device, old_dofs.device))
    if const.device.type == "cpu":
        return plain_solve_dofs(const, old_dofs, steps, mindof, maxdof)
    if const.device.type != "cuda":
        raise TypeError("no kernels for device type %r" % const.device.type)
    if const.dtype not in (torch.float32, torch.float64):
        raise TypeError("solve_dofs takes float32 or float64 tensors, got %s" % const.dtype)
    K = const.shape[0]
    const, old_dofs = const.contiguous(), old_dofs.contiguous()
    _check(const, (K,), const.dtype)
    _check(old_dofs, (K,), const.dtype)
    lib = _build.load()
    out = torch.empty_like(const)
    with torch.cuda.device(const.device):
        err = lib.pmc_solve_dofs(const.data_ptr(), old_dofs.data_ptr(), out.data_ptr(), K,
                                 int(steps), float(mindof), float(maxdof),
                                 int(const.dtype == torch.float64),
                                 _DOF_VARIANTS.index(variant), _stream(const.device))
    _raise_on(err, "solve_dofs")
    solve_dofs.launches += 1
    _variant_counts["solve_dofs=" + variant] += 1
    return out


def draw_proposal_inputs(seed, cumw, dof, n: int, D: int, normals: bool):
    """The random inputs of ``n`` draws from a mixture with the tail-sum
    thresholds ``cumw (K,)`` (``density.core._cumulative_weights``) and,
    for a Student-t mixture, the dofs ``dof (K,)`` (None: Gaussian), in one
    launch of kernel ``csrc/draw.cu`` (float32 or float64, the dtype of
    ``cumw``): ``(latent (n,) int32, zT (D, n), scale (n,))``, the
    component of each particle by one uniform against the thresholds (a
    dead component is never drawn), and with ``normals`` its standard
    normals and its scale ``sqrt(dof / max(chi2(dof), tiny))`` (1 for a
    Gaussian mixture); ``zT`` and ``scale`` are None without.  The stream
    of particle n is Philox keyed by the two ``seed`` words with bit 1 of
    the second flipped (its own: the draw kernels key theirs by the words,
    ``fused_transform_rng`` in ``propose_T`` with bit 0 flipped), counted
    by n.  ``seed``: as :func:`fused_propose_logq`'s."""
    if dof is not None and dof.device != cumw.device:
        raise ValueError("tensors on different devices: %s, %s" % (cumw.device, dof.device))
    if cumw.device.type == "cpu":
        return plain_draw_proposal_inputs(seed, cumw, dof, n, D, normals)
    if cumw.device.type != "cuda":
        raise TypeError("no kernels for device type %r" % cumw.device.type)
    if cumw.dtype not in (torch.float32, torch.float64):
        raise TypeError("draw_proposal_inputs takes float32 or float64 tensors, got %s"
                        % cumw.dtype)
    K, device, dtype = cumw.shape[0], cumw.device, cumw.dtype
    _check(cumw, (K,), dtype)
    if dof is not None:
        _check(dof, (K,), dtype)
    lib = _build.load()
    latent = torch.empty((n,), dtype=torch.int32, device=device)
    zT = torch.empty((D, n), dtype=dtype, device=device) if normals else None
    scale = torch.empty((n,), dtype=dtype, device=device) if normals else None
    with torch.cuda.device(device):
        err = lib.pmc_draw_proposal_inputs(
            *_seed_args(seed, device), cumw.data_ptr(),
            None if dof is None else dof.data_ptr(), latent.data_ptr(),
            None if zT is None else zT.data_ptr(), None if scale is None else scale.data_ptr(),
            n, K, D, int(dtype == torch.float64), _blocks(device, n, 8, _build.DRAW_THREADS),
            _stream(device))
    _raise_on(err, "draw_proposal_inputs")
    draw_proposal_inputs.launches += 1
    return latent, zT, scale


def _launch_draw_transform(fn, rng, seed, ops: MixtureOperands, n: int):
    """One launch of ``csrc/draw.cu``'s draw_transform_rec_kernel for
    ``fn``, :func:`fused_draw_transform` or (``rng``)
    :func:`fused_draw_transform_rng`, or on the CPU its plain version."""
    K, D = ops.K, ops.dim
    if _build.draw_transform_plan(K, D)[0] != "rec":
        raise ValueError("%s: D=%d is past its record kernel's D <= %d; propose_T draws with "
                         "draw_proposal_inputs and transforms after it there"
                         % (fn.__name__, D, _build._REC_D_MAX))
    if not use_kernel(ops.packed):
        return (plain_draw_transform_rng if rng else plain_draw_transform)(seed, ops, n)
    _check_operands(ops)
    device = ops.packed.device
    lib = _build.load()
    latent = torch.empty((n,), dtype=torch.int32, device=device)
    xT = torch.empty((D, n), dtype=torch.float32, device=device)
    n_blocks = _blocks(device, n, _rec_per_sm(fn.__name__, K, D, 0, device.index),
                       _build.EVAL_THREADS)
    with torch.cuda.device(device):
        err = lib.pmc_fused_draw_transform(
            *_seed_args(seed, device), ops.packed.data_ptr(), latent.data_ptr(), xT.data_ptr(),
            n, K, D, int(ops.student_t), int(rng), n_blocks, _stream(device))
    _raise_on(err, fn.__name__)
    fn.launches += 1
    return xT, latent


def fused_draw_transform(seed, ops: MixtureOperands, n: int):
    """``n`` draws from the packed mixture as :func:`draw_proposal_inputs`
    (with the normals), then :func:`fused_transform`, draw them, in one
    launch (kernel ``csrc/draw.cu``, D <= 64; float32 on the card): the
    components, normals and Student-t scales of draw_proposal_inputs'
    stream, kept in registers, transformed on the record kernel's records
    -> ``(xT (D, n), latent (n,) int32)``, the two launches' outputs bit for
    bit.  ``seed``: as :func:`fused_propose_logq`'s (a seed tensor is read
    in the kernel).  Past D = 64 it raises."""
    return _launch_draw_transform(fused_draw_transform, False, seed, ops, n)


def fused_draw_transform_rng(seed, ops: MixtureOperands, n: int):
    """``n`` draws from the packed mixture as :func:`draw_proposal_inputs`
    (the components only), then :func:`fused_transform_rng` keyed by the
    words with bit 0 of the second flipped, draw them, in one launch (kernel
    ``csrc/draw.cu``, D <= 64; float32 on the card): ``(xT (D, n), latent
    (n,) int32)``, the two launches' outputs bit for bit; the flip is made in
    the kernel, so a seed tensor is read as it is.  Past D = 64 it
    raises."""
    return _launch_draw_transform(fused_draw_transform_rng, True, seed, ops, n)


_WRAPPERS = (fused_logq, fused_propose_logq, fused_pmc_stats, fused_is_pmc_step,
             fused_maha, fused_rho, fused_vb_estep, fused_transform,
             fused_transform_rng, fused_mcmc_pool, fused_pmc_stats_blocked,
             fused_vb_estep_blocked, fused_is_pmc_step_blocked, solve_dofs,
             draw_proposal_inputs, fused_draw_transform, fused_draw_transform_rng)


_variant_counts = {}


def reset_launch_counts():
    """Set every wrapper's launch count, every plain route's count and
    every variant's count to 0 (a K-blocked kernel has no route of its own:
    its dense twin's gate counts)."""
    for fn in _WRAPPERS:
        fn.launches = 0
        if fn.__name__ in _build.KERNELS and fn.__name__ not in _build.BLOCKED:
            _plain_routes[fn.__name__] = 0
    for name in _build.DRAWS + _build.TILED + _build._DENSE:
        for variant in _variant_names(name):
            _variant_counts["%s=%s" % (name, variant)] = 0
    for variant in _POOL_VARIANTS:
        _variant_counts["fused_mcmc_pool=" + variant] = 0
    for variant in _DOF_VARIANTS:
        _variant_counts["solve_dofs=" + variant] = 0


def launch_counts() -> dict:
    """``{wrapper name: kernel launches, "plain:" + wrapper name: times the
    size gate sent an "auto" dispatch past the kernel, "variant:" + wrapper
    name + "=" + variant: the launches of each variant of the kernels that
    have several}`` since the last reset."""
    counts = {fn.__name__: fn.launches for fn in _WRAPPERS}
    counts.update({"plain:" + name: n for name, n in _plain_routes.items()})
    counts.update({"variant:" + name: n for name, n in _variant_counts.items()})
    return counts


def add_launch_counts(delta, times=1):
    """Add ``times`` x ``delta``, a difference of two :func:`launch_counts`,
    to the counts: a CUDA graph launches on each replay the kernels its
    capture recorded, where the wrappers counted them once."""
    for fn in _WRAPPERS:
        fn.launches += times * delta.get(fn.__name__, 0)
    for name in _plain_routes:
        _plain_routes[name] += times * delta.get("plain:" + name, 0)
    for name in _variant_counts:
        _variant_counts[name] += times * delta.get("variant:" + name, 0)


reset_launch_counts()
