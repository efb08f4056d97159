"""Data-parallel importance sampling and PMC over the particle axis.

Counterpart of :mod:`pypmc_tpu.parallel.sampler` (the reference's
``MPISampler``, ``tools/parallel_sampler.py``, and its MPI PMC pipeline,
``examples/pmc_mpi.py``).  With a particle mesh
(:func:`~pypmc_tpu_torch.parallel.mesh.particle_mesh`) each rank draws its
own shard of the particles, computes the sufficient statistics of its
shard -- the same CUDA kernels as in one process -- and one ``all_reduce``
of the O(K D^2) statistics gives every rank the same sums, so every rank
applies the same update and holds the same adapted mixture: no rank
broadcasts a proposal.  Every reduction over particles passes through the
``reduce`` hook of :mod:`pypmc_tpu_torch.mix_adapt.pmc`, which the mesh
supplies (:meth:`~pypmc_tpu_torch.parallel.mesh.ParticleMesh.reduce`).

Without a mesh the run is one process on one device; a ``torch.distributed``
group of more than one rank then asks for a mesh.  The parameter lists are
the JAX package's, ``mesh`` and ``axis_name`` included, so a positional
call means the same in both.

``pmc_run_sharded(scan_steps=True)`` runs its steps as the JAX package's
one compiled ``lax.scan`` does (``pypmc_tpu/parallel/sampler.py:314-332``):
through a :class:`~pypmc_tpu_torch.sampler._scan.Scan`, CUDA graphs of up
to ``_scan.CHUNK`` whole PMC steps replayed on the card, the mixture
carried in fixed buffers and every step's seed words drawn before the run
into a table on the device, which the step's random kernels read
themselves.  The scans are kept across calls, as the JAX package keeps its
compiled steps (:func:`clear_step_cache` drops them).
"""

import functools
import logging
from collections import OrderedDict
from typing import NamedTuple

import numpy as _np
import torch

from .. import _rng
from .. import profiling as _profiling
from ..density import core as _core
from ..mix_adapt.pmc import (pmc_log_likelihood, pmc_step_mixture_target,
                             pmc_update)
from ..ops import kernels as _k
from ..sampler import _scan
from ..sampler._target import evaluate_target_T
from ..tools import History as _History
from ..tools.indicator import merge_function_with_indicator as _indmerge
from .mesh import PARTICLE_AXIS, checked, particle_mesh

logger = logging.getLogger(__name__)

__all__ = ["ParallelSampler", "run_is_step_sharded", "pmc_run_sharded", "PMCStepStats",
           "clear_step_cache"]


# the scan of pmc_run_sharded(scan_steps=True)'s last configuration, by
# what its steps' work depends on: it holds its CUDA graphs and the memory
# pools they replay in (at 10^7 particles a step, hundreds of MiB: PERF.md
# section 5), so only the last is kept
_SCANS = OrderedDict()
_SCANS_MAX = 1


def clear_step_cache():
    """Drop the scan ``pmc_run_sharded(scan_steps=True)`` keeps across
    calls, with its CUDA graphs; their memory goes back to PyTorch's cache
    (``torch.cuda.empty_cache()`` returns it to the card).  The JAX
    package's name: it drops its compiled steps."""
    _SCANS.clear()


def _mesh_of(mesh, entry):
    """``mesh`` checked: a :class:`~pypmc_tpu_torch.parallel.mesh.ParticleMesh`,
    or None in a process outside a group of more than one rank."""
    if mesh is None:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "%s without a mesh runs in one process; in a torch.distributed group "
                "of %d ranks pass mesh=pypmc_tpu_torch.parallel.particle_mesh()"
                % (entry, dist.get_world_size()))
    return checked(mesh)


def _local_count(mesh, n_total, what):
    """Particles of this rank: ``n_total`` rounded up to a multiple of the
    mesh's ranks, split evenly."""
    size = 1 if mesh is None else mesh.size
    n_local = -(-int(n_total) // size)   # ceil: any n_total is accepted
    if n_local * size != n_total:
        logger.info("n_total=%d is not divisible by %d ranks; drawing %d %s",
                    n_total, size, n_local * size, what)
    return n_local


# a rank's seed words: the caller's words with the rank folded in (rank 0
# keeps them, so that a one-rank mesh draws what no mesh draws)
_FOLD = 0x9E3779B97F4A7C15


def _rank_key(gen, mesh):
    """The next two seed words of ``gen`` for this rank.  Every rank advances
    ``gen`` alike; rank r > 0 xors a multiple of the golden-ratio constant
    into the words, so that each rank draws a stream of its own."""
    s0, s1 = _rng.seed_words(gen)
    rank = 0 if mesh is None else mesh.rank
    h = (rank * _FOLD) & 0xFFFFFFFFFFFFFFFF
    return s0 ^ (h >> 32), s1 ^ (h & 0xFFFFFFFF)


def _is_body(params, key, n, target, strict=False):
    """Propose, evaluate and weight ``n`` particles (transposed layout).  A
    MIXTURE target is evaluated inside the same kernel as the proposal; a
    callable as the importance sampler evaluates it: a batched one on the
    block, a per-point one mapped over the particles.  ``strict`` (a CUDA
    graph is captured) checks the callable's values."""
    if isinstance(target, _core.MixtureParams):
        samples_T, latent, log_q, log_p = _core.propose_logq_T(params, key, n, target)
    else:
        samples_T, latent, log_q = _core.propose_logq_T(params, key, n)
        log_p = evaluate_target_T(target, samples_T)
        if strict:
            _scan.check_capturable(log_p, samples_T)
    return samples_T, torch.exp(log_p - log_q), latent


def run_is_step_sharded(params, target, key, n_total, mesh=None,
                        axis_name=PARTICLE_AXIS):
    """Draw ``n_total`` importance samples; return ``(samples_T (D, n),
    weights (n,), latent (n,))``.  ``target`` is a log-density callable (a
    per-point one, mapped over the particles, or a batched one) or a
    :class:`~pypmc_tpu_torch.density.core.MixtureParams` (evaluated inside
    the draw's kernel); ``key`` an int seed or a ``torch.Generator``.

    With a particle ``mesh``, ``n_total`` is rounded up to a multiple of its
    ranks, and each rank draws and returns its own shard, ``n = n_total /
    size`` particles, from the key with its rank folded in.  ``axis_name``
    is the JAX package's; the mesh carries its own."""
    mesh = _mesh_of(mesh, "run_is_step_sharded")
    n_local = _local_count(mesh, n_total, "instead")
    return _is_body(params, _rank_key(_rng.as_generator(key), mesh), n_local, target)


class PMCStepStats(NamedTuple):
    log_likelihood: torch.Tensor  # [Cap+08] eq. (5) of the UPDATED mixture
    perplexity: torch.Tensor      # normalized perplexity of the weights
    ess: torch.Tensor             # normalized effective sample size
    evidence: torch.Tensor        # mean weight = integral estimate


def _pmc_step(params, target, key, n_local, mesh, rb, steps, mindof, maxdof,
              compute_log_likelihood, weight_clip, strict=False):
    """One PMC step of ``n_local`` particles on this rank from the seed
    words ``key``: ``(the updated params, PMCStepStats of 0-d tensors,
    samples_T, weights)``.  ``strict``: a CUDA graph is being captured."""
    n = n_local * (1 if mesh is None else mesh.size)
    reduce = None if mesh is None else mesh.reduce
    red = reduce or (lambda x: x)
    if isinstance(target, _core.MixtureParams) and rb and not weight_clip:
        result, samples_T, weights, latent, sw = pmc_step_mixture_target(
            params, target, key, n_local, dof_solver_steps=steps,
            mindof=mindof, maxdof=maxdof, reduce=reduce)
        sum_w, sum_w2, sum_wlogw = sw[0], sw[1], sw[2]
    else:
        samples_T, weights, latent = _is_body(params, key, n_local, target, strict)
        sum_w = red(torch.sum(weights))
        w_adapt = weights
        if weight_clip:
            # the clip is the GLOBAL mean weight times sqrt(n)
            w_adapt = torch.minimum(weights, (sum_w / n) * n ** 0.5)
        result = pmc_update(params, samples_T, w_adapt,
                            latent=None if rb else latent, rb=rb,
                            dof_solver_steps=steps, mindof=mindof,
                            maxdof=maxdof, reduce=reduce, transposed=True)
        sums = red(torch.stack([torch.sum(weights * weights),
                                torch.sum(torch.special.xlogy(weights, weights))]))
        sum_w2, sum_wlogw = sums[0], sums[1]
    # weight diagnostics from the raw sums: the entropy of the
    # normalized weights is log(sum w) - (sum w log w) / (sum w)
    entr = torch.log(sum_w) - sum_wlogw / sum_w
    perp = torch.exp(entr) / n
    coeff_var = sum_w2 * n / sum_w ** 2 - 1.0
    ess = 1.0 / (1.0 + coeff_var)
    if compute_log_likelihood:
        loglik = pmc_log_likelihood(result.params, samples_T, weights / sum_w,
                                    reduce=reduce, transposed=True)
    else:
        loglik = torch.full((), float("nan"), dtype=weights.dtype,
                            device=weights.device)
    stats = PMCStepStats(log_likelihood=loglik, perplexity=perp, ess=ess, evidence=sum_w / n)
    return result.params, stats, samples_T, weights


def _uncapturable(params, target, n_local, mesh, rb, weight_clip):
    """Why a CUDA graph cannot replay these steps, or None: a draw that is
    no kernel's seeds a generator on the host from its words every step (a
    replay would draw the capture's particles again), and a gloo all-reduce
    crosses the host."""
    if mesh is not None and mesh.group is not None \
            and torch.distributed.get_backend(mesh.group) != "nccl":
        return "the mesh's %s all_reduce crosses the host" % torch.distributed.get_backend(
            mesh.group)
    K, D = params.K, params.dim
    Kt = target.K if isinstance(target, _core.MixtureParams) else 0
    if isinstance(target, _core.MixtureParams) and rb and not weight_clip and (
            _k.fits("fused_is_pmc_step", K, D, Kt, n=n_local)
            or _k.elects_blocked("fused_is_pmc_step", K, D, n_local, Kt)):
        return None
    if _k.fits("fused_propose_logq", K, D, Kt):
        return None
    return ("the draw of K=%d, D=%d (a %d-component target) is no kernel's: it seeds a "
            "generator on the host every step" % (K, D, Kt))


def _pmc_steps(settings, target, xs, ys, carry, consts, strict):
    """The body of a scan of PMC steps: ``len(seeds)`` steps from the
    mixture ``carry`` (its tensors in ``MixtureParams``' order), step i from
    the seed words ``seeds[i]`` of ``xs = (seeds,)``, its statistics into
    ``ys`` (``PMCStepStats``' order), the mixture back into ``carry``; a
    mixture target's tensors are ``consts``.  ``strict`` raises
    :class:`~pypmc_tpu_torch.sampler._scan.Uncapturable` before a step that
    no graph can replay."""
    (seeds,) = xs
    params = _core.MixtureParams(*carry)
    if consts:
        target = _core.MixtureParams(*consts)
    if strict:
        cause = _uncapturable(params, target, settings["n_local"], settings["mesh"],
                              settings["rb"], settings["weight_clip"])
        if cause is not None:
            raise _scan.Uncapturable(cause)
    for i in range(seeds.shape[0]):
        params, stats, _, _ = _pmc_step(params, target, seeds[i], strict=strict, **settings)
        for y, v in zip(ys, stats):
            y[i] = v
    for c, v in zip(carry, _tensors(params)):
        c.copy_(v)


def _tensors(params):
    return tuple(t for t in (getattr(params, f) for f in _core._FIELDS) if t is not None)


def _scan_of(target, params, settings):
    """The scan of these steps, kept across calls (a new one where the key
    cannot be hashed)."""
    mesh = settings["mesh"]
    if isinstance(target, _core.MixtureParams):
        body_target = None
        token = ("mixture",) + tuple((t.shape, t.dtype) for t in _tensors(target))
    else:
        body_target = token = target
    key = (token, None if mesh is None else (mesh.size, mesh.rank, mesh.group, mesh.device),
           tuple((t.shape, t.dtype, t.device) for t in _tensors(params)),
           tuple(sorted((k, v) for k, v in settings.items() if k != "mesh")))
    try:
        scan = _SCANS.get(key)
    except TypeError:   # an unhashable callable
        return _scan.Scan(functools.partial(_pmc_steps, settings, body_target))
    if scan is None:
        scan = _scan.Scan(functools.partial(_pmc_steps, settings, body_target))
        _SCANS[key] = scan
    _SCANS.move_to_end(key)
    while len(_SCANS) > _SCANS_MAX:
        _SCANS.popitem(last=False)
    return scan


def pmc_run_sharded(target, params, n_total, n_steps, mesh=None, key=None,
                    rb=True, dof_solver_steps=100, mindof=1e-5, maxdof=1e3,
                    axis_name=PARTICLE_AXIS, return_final_samples=False,
                    scan_steps=False, compute_log_likelihood=True,
                    weight_clip=False):
    """Run ``n_steps`` of (M-)PMC with ``n_total`` fresh particles per step
    on the device that holds ``params``.

    Each step with a MIXTURE target and ``rb=True`` runs the particle work
    as one kernel (``fused_is_pmc_step``, from 1024 particles a rank);
    otherwise it draws and weights the particles (``fused_propose_logq``)
    and then runs
    :func:`~pypmc_tpu_torch.mix_adapt.pmc.pmc_update`.  Each step opens the
    range ``pmc_step`` in a :func:`pypmc_tpu_torch.profiling.trace`.

    :param target: log target density callable, or
        :class:`~pypmc_tpu_torch.density.core.MixtureParams`.
    :param params: initial mixture; Student-t iff ``params.dof`` is not None.
    :param n_total: particles per step; with a mesh rounded up to a multiple
        of its ranks (each rank draws ``n_total / size``).
    :param n_steps: number of PMC adaptation steps.
    :param mesh: None (one process), or a particle mesh
        (:func:`~pypmc_tpu_torch.parallel.mesh.particle_mesh`): each rank
        draws its shard, the sufficient statistics and the weight sums are
        summed over the ranks, and every rank ends each step with the same
        mixture.  A one-rank mesh draws what None draws.
    :param key: int seed or ``torch.Generator`` (None: seed 0); each step
        takes fresh seed words from it, with the rank folded in.
    :param axis_name: the JAX package's mesh axis; the mesh carries its own.
    :param weight_clip: clip the weights at ``global mean * sqrt(n)`` for the
        ADAPTATION only (truncated importance sampling, Ionides 2008);
        diagnostics and evidence stay unclipped.
    :param scan_steps: run the steps as the JAX package's one ``lax.scan``:
        as CUDA graphs of whole steps on the card (the range ``pmc_scan``
        for the whole run, none a step), with every step's seed words drawn
        before the run, in the order the loop draws them, so the results
        equal ``scan_steps=False``'s bit for bit.  The graphs pay on
        repeated calls at the same shapes (the JAX package's
        ``benchmarks/weak_scaling.py`` pattern): a new configuration's
        first :data:`~pypmc_tpu_torch.sampler._scan.CHUNK` steps run
        eagerly, so its first call of that many steps or fewer replays
        nothing; the scan of the last configuration is kept, with its
        graphs' memory, until another replaces it or
        :func:`clear_step_cache`.  Steps no graph can replay (a draw that
        is no kernel's, a gloo mesh) run eagerly, with one warning
        (``sampler._scan``).  ``return_final_samples`` is not available
        with it.
    :param compute_log_likelihood: False skips the extra evaluation pass per
        step (``stats.log_likelihood`` is then NaN).

    Returns ``(params, stats)`` with ``stats`` a :class:`PMCStepStats` of
    ``(n_steps,)`` tensors; with ``return_final_samples`` additionally the
    last step's ``(samples_T (D, n), weights (n,))``: this rank's shard.
    """
    mesh = _mesh_of(mesh, "pmc_run_sharded")
    if scan_steps and return_final_samples:
        raise ValueError("return_final_samples is not available with scan_steps=True")
    gen = _rng.as_generator(0 if key is None else key)
    settings = dict(n_local=_local_count(mesh, n_total, "per step"), mesh=mesh, rb=rb,
                    steps=dof_solver_steps if params.is_student_t else 0, mindof=mindof,
                    maxdof=maxdof, compute_log_likelihood=compute_log_likelihood,
                    weight_clip=weight_clip)
    if scan_steps:
        device, dtype = params.means.device, params.means.dtype
        seeds = torch.tensor([_rank_key(gen, mesh) for _ in range(n_steps)],
                             dtype=torch.int64).reshape(n_steps, 2).to(device)
        ys = tuple(torch.empty((n_steps,), dtype=dtype, device=device)
                   for _ in PMCStepStats._fields)
        consts = _tensors(target) if isinstance(target, _core.MixtureParams) else ()
        with _profiling.annotate("pmc_scan"):
            carry = _scan_of(target, params, settings).run((seeds,), ys, _tensors(params),
                                                           consts)
        return _core.MixtureParams(*carry), PMCStepStats(*ys)

    all_stats = []
    samples_T = weights = None
    for _ in range(n_steps):
        with _profiling.annotate("pmc_step"):
            params, stats, samples_T, weights = _pmc_step(
                params, target, _rank_key(gen, mesh), **settings)
        all_stats.append(stats)

    stats = PMCStepStats(*[torch.stack([getattr(s, f) for s in all_stats])
                           for f in PMCStepStats._fields])
    if return_final_samples:
        return params, stats, samples_T, weights
    return params, stats


class ParallelSampler(object):
    """Data-parallel importance sampler over a particle mesh (the
    reference's ``MPISampler``, ``tools/parallel_sampler.py:7-80``).

    There is no master rank: every rank draws ``N`` particles a run, and
    the host Histories of every rank hold the *global* samples and weights,
    all-gathered in rank order.  ``samples_list`` and ``weights_list`` give
    the per-rank view of the last run.

    :param target: log target density (a per-point callable, a batched
        target, or a :class:`~pypmc_tpu_torch.density.core.MixtureParams`,
        evaluated inside the draw's kernel).
    :param proposal: Gaussian or Student-t
        :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity`.
    :param mesh: a particle mesh (default: :func:`particle_mesh`, the
        initialized group's ranks or one process); the runs happen on its
        device.
    :param indicator, prealloc, save_target_values, rng: as in
        :class:`~pypmc_tpu_torch.sampler.importance_sampling.ImportanceSampler`
        (``rng``: an int seed, a ``torch.Generator`` or None).
    """

    def __init__(self, target, proposal, mesh=None, indicator=None,
                 prealloc=0, save_target_values=False, rng=None):
        self.mesh = particle_mesh() if mesh is None else checked(mesh)
        self.n_devices = self.mesh.size
        self.proposal = proposal
        self.target = _indmerge(target, indicator, -_np.inf)
        self.target_values = _History(1, prealloc) if save_target_values else None
        self.weights = _History(1, prealloc)
        self.samples = _History(proposal.dim, prealloc)
        self._gen = _rng.as_generator(0 if rng is None else rng)
        # device-resident runs not yet flushed to the host Histories:
        # (samples_T (D, n), weights (n,), the proposal's params that drew them)
        self._device_pending = []

    def run(self, N=1, trace_sort=False, to_host=True):
        """Draw ``N`` samples *per rank* (``N * size`` in all, as
        ``MPISampler`` draws ``N`` a rank, ``tools/parallel_sampler.py:35-58``).

        With ``to_host=True`` (default) the global samples and weights are
        all-gathered into the host Histories of every rank.  With
        ``to_host=False`` they stay on the device, each rank with its own
        shard (:attr:`device_runs`), until :meth:`gather` or the next
        ``to_host=True`` run; :meth:`evidence_stats` reduces them there.

        Return the latent component indices if ``trace_sort`` (the global
        ones with ``to_host``, else this rank's)."""
        if N == 0:
            return 0
        # a mixture target is evaluated beside the proposal: in its dtype
        dtype = self.target.means.dtype if isinstance(self.target, _core.MixtureParams) else None
        params = self.proposal.stacked_params(dtype=dtype, device=self.mesh.device)
        samples_T, weights, latent = run_is_step_sharded(
            params, self.target, self._gen, int(N) * self.n_devices, self.mesh)
        # the pending run keeps the params that drew it: the target values
        # are reconstructed with them even if self.proposal is adapted first
        self._device_pending.append((samples_T, weights, params))
        if to_host:
            self.gather()
        if trace_sort:
            return self.mesh.all_gather(latent).numpy() if to_host else latent
        return None

    @property
    def device_runs(self):
        """Device-resident ``(samples_T, weights)`` tuples of the runs not
        yet flushed to the host Histories (``to_host=False`` runs): this
        rank's shards."""
        return [(s, w) for s, w, _ in self._device_pending]

    def _target_values(self, samples_T, weights, run_params):
        """log P at this rank's particles of a run: ``log w + log q``, and
        the target itself where a float32 weight underflowed to 0 (the
        finite log P it came from is lost there)."""
        log_q = _core.mixture_logpdf_T(run_params, samples_T)
        tv = torch.log(weights) + log_q
        bad = torch.nonzero(weights == 0).squeeze(1)
        if bad.numel():
            xs_bad = samples_T[:, bad].contiguous()
            if isinstance(self.target, _core.MixtureParams):
                tv[bad] = _core.mixture_logpdf_T(self.target, xs_bad).to(tv.dtype)
            else:
                tv[bad] = evaluate_target_T(self.target, xs_bad).to(tv.dtype)
        return tv

    def gather(self):
        """Flush all device-resident runs into the host Histories of every
        rank (an all-gather, rank 0's shard first: the symmetric form of
        ``MPISampler``'s gather to rank 0).  Returns the number of runs
        flushed."""
        for samples_T, weights, run_params in self._device_pending:
            samples = self.mesh.all_gather(samples_T.T).numpy()
            n = len(samples)
            self.samples.append(n)[:] = samples
            self.weights.append(n)[:, 0] = self.mesh.all_gather(weights).numpy()
            if self.target_values is not None:
                tv = self._target_values(samples_T, weights, run_params)
                self.target_values.append(n)[:, 0] = self.mesh.all_gather(tv).numpy()
        flushed = len(self._device_pending)
        self._device_pending = []
        return flushed

    def evidence_stats(self):
        """``(sum w, sum w^2, n)`` over ALL runs: the host Histories (already
        global) and the device-resident runs, those summed over the ranks
        on the device, so only three numbers reach the host.  Evidence =
        ``sum_w / n``; perplexity and ESS follow from the same sums."""
        w_host = self.weights[:][:, 0] if len(self.weights) else _np.zeros(0)
        sum_w, sum_w2, n = float(w_host.sum()), float((w_host ** 2).sum()), len(w_host)
        for _, w, _ in self._device_pending:
            sums = self.mesh.reduce(torch.stack([torch.sum(w), torch.sum(w * w)]))
            sum_w += float(sums[0])
            sum_w2 += float(sums[1])
            n += int(w.shape[0]) * self.n_devices
        return sum_w, sum_w2, n

    @property
    def samples_list(self):
        """Per-rank view of the last run's samples (``MPISampler``'s
        ``samples_list``).  Flushes pending device-resident runs first, so
        that "last run" is the chronologically last one."""
        self.gather()
        return _np.array_split(self.samples[-1], self.n_devices)

    @property
    def weights_list(self):
        """Per-rank view of the last run's weights (flushes pending
        device-resident runs first)."""
        self.gather()
        return _np.array_split(self.weights[-1], self.n_devices)

    def clear(self):
        """Clear the Histories AND drop any device-resident pending runs."""
        self.samples.clear()
        self.weights.clear()
        if self.target_values is not None:
            self.target_values.clear()
        self._device_pending = []
