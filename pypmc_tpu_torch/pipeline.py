"""One-call evidence estimation: the full adaptive-importance-sampling
pipeline as a library function.

Counterpart of :mod:`pypmc_tpu.pipeline`:

    adaptive-MCMC chain pool -> Gelman-Rubin grouping (one long patch per
    group) -> variational Bayes -> inflated first IS run -> weighted-VB
    refinement -> Student-t M-PMC refinement -> final IS run ->
    deterministic-mixture combination.

On the card every stage runs the CUDA kernels where the JAX package runs
its Pallas kernels: ``fused_mcmc_pool`` for a mixture target's chain pool,
``fused_vb_estep`` for the VB E-steps, ``fused_propose_logq`` and
``fused_logq`` for the IS runs, the PMC refinement and the combination.
In one process both IS runs stay on the device: VB2 and the combination
read them there.  With a particle mesh (``mesh=``) every rank runs the
pipeline: the VB fits and the PMC refinement sum their statistics over the
ranks, the IS runs draw a shard a rank and are all-gathered to every rank's
host, and every rank ends with the same result.  Each stage opens a range
in a :func:`pypmc_tpu_torch.profiling.trace`, named after its ``details``
key (``mcmc``, ``vb1``, ``is1_vb2``, ``pmc``, ``is2_combine``).
"""

import logging
import os
import time
from typing import NamedTuple

import numpy as _np
import torch

from . import _device, _rng
from . import checkpoint as _checkpoint
from . import density as _density
from . import mix_adapt as _mix_adapt
from . import sampler as _sampler
from . import tools as _tools
from .density import core as _core
from .mix_adapt.pmc import pmc_step_mixture_target, pmc_update
from .parallel import ParallelSampler, pmc_run_sharded
from .parallel.mesh import checked
from .parallel.sampler import block_target
from .profiling import annotate

logger = logging.getLogger(__name__)

__all__ = ["integrate", "IntegrateResult"]


class IntegrateResult(NamedTuple):
    """Result of :func:`integrate`."""

    evidence: float                # integral estimate of exp(log_target)
    uncertainty: float             # Monte-Carlo standard error
    perplexity: float              # normalized perplexity of the weights
    ess: float                     # normalized effective sample size
    proposal: object               # final adapted MixtureDensity (Student-t)
    n_samples: int                 # combined sample count
    samples: object                # (N, D) combined IS samples (numpy) or None
    weights: object                # (N,) combined deterministic-mixture weights
    details: dict                  # per-stage diagnostics and wall times


def _sub_seed(gen):
    """An int seed for the next stage, drawn from the run's generator."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=gen))


def integrate(target, dim, starts, *, key=None, mesh=None, n_chains=None,
              checkpoint_dir=None,
              mcmc_steps=400, mcmc_cycles=12, thin=5, K_g=1,
              critical_r=2.0, inflate=2.0, pmc_steps=10, pmc_dof=8.0,
              pmc_weight_clip=True, return_samples=True,
              n_is1=1 << 17, n_is2=1 << 19, vb_iterations=300,
              rel_tol=1e-8, abs_tol=1e-5, verbose=False, device=None):
    r"""Estimate :math:`Z = \int e^{\log P(x)}\,dx` for a multimodal target
    with (almost) no analytical knowledge, via the full adaptive pipeline.

    :param target: the log target density -- a callable ``x (D,) -> log
        P(x)`` on a tensor (or a batched target,
        :func:`~pypmc_tpu_torch.sampler.batched_target`), or a
        :class:`~pypmc_tpu_torch.density.mixture.MixtureDensity` /
        :class:`~pypmc_tpu_torch.density.core.MixtureParams` (mixture
        targets run the fused kernel paths: the chain pool, the PMC step).
    :param dim: dimension D.
    :param starts: ``(C, D)`` Markov-chain starting points covering the
        region of interest; the target must be finite at every start.
    :param key: int seed or ``torch.Generator`` (default: seed 0).
    :param mesh: a particle mesh
        (:func:`pypmc_tpu_torch.parallel.particle_mesh`): every rank calls
        ``integrate`` with the same arguments; the IS runs draw
        ``ceil(n / size)`` particles a rank (:class:`~pypmc_tpu_torch.parallel.ParallelSampler`,
        gathered to every rank's host), VB1 and VB2 sum their statistics
        over the ranks, and the PMC refinement is
        :func:`~pypmc_tpu_torch.parallel.pmc_run_sharded` over the mesh.
        Only rank 0 writes checkpoints.  None: one process.
    :param checkpoint_dir: optional directory for stage checkpoints (plain
        ``.npz``; the JAX package's files are read as they are).  Each
        completed stage (MCMC prerun, first VB fit, refined proposal) is
        saved; a re-run with the same directory and settings resumes from
        the furthest completed stage (from the refined proposal only the
        final sampling stage runs, and the estimate uses it alone).
    :param n_chains: use only the first ``n_chains`` rows of ``starts``.
    :param mcmc_steps, mcmc_cycles: adaptive-Metropolis schedule
        ([HST01]); total chain length is their product, half is burn-in.
    :param thin: thinning of the pooled MCMC samples fed to VB.
    :param K_g: long patches per chain group (keep 1 for D >= 20).
    :param critical_r: Gelman-Rubin grouping threshold.
    :param inflate: first-run proposal covariance inflation.
    :param pmc_steps, pmc_dof: Student-t M-PMC refinement schedule; 0
        steps disables the stage.
    :param pmc_weight_clip: clip the importance weights at ``mean(w) *
        sqrt(n)`` for the ADAPTATION only (Ionides 2008); the evidence
        always uses unclipped weights.
    :param n_is1, n_is2: particle counts of the two IS runs.
    :param vb_iterations, rel_tol, abs_tol: VB convergence controls.
    :param return_samples: with False, ``result.samples`` is None and the
        combined samples never leave the device.
    :param device: where the run happens (default:
        :func:`pypmc_tpu_torch.default_device`; a
        :class:`~pypmc_tpu_torch.density.core.MixtureParams` target gives
        its own).
    :returns: :class:`IntegrateResult`.
    """
    mesh = checked(mesh)
    n_dev = 1 if mesh is None else mesh.size
    say = logger.info if not verbose else (lambda *a: print(a[0] % tuple(a[1:])))
    t_all = time.perf_counter()
    gen = _rng.as_generator(0 if key is None else key)

    # normalize the target forms: mcmc_target feeds the chain pool (a
    # MixtureParams runs fused_mcmc_pool), log_target feeds IS
    target_params = None
    if isinstance(target, _core.MixtureParams):
        target_params = target
        device = target.device if device is None else device
    device = _device.default_device(device)
    if isinstance(target, _density.MixtureDensity):
        target_params = target.stacked_params(device=device)
        log_target = target.evaluate_fn(batched=True, device=device)
    elif target_params is not None:
        target_params = target_params.to(device=device)

        @_sampler.batched_target(transposed=True)
        def log_target(xT, _tp=target_params):
            return _core.mixture_logpdf_T(_tp, xT.to(_tp.means.dtype).contiguous())
    else:
        log_target = target
    mcmc_target = target_params if target_params is not None else log_target
    dtype = (target_params.means.dtype if target_params is not None
             else _device.working_dtype(device))

    starts = _np.asarray(starts.cpu() if isinstance(starts, torch.Tensor) else starts)
    if n_chains is not None:
        starts = starts[:n_chains]
    if starts.ndim != 2 or starts.shape[1] != dim:
        raise ValueError("starts must be (n_chains, %d), got %s" % (dim, starts.shape))

    details = {}

    def _ck(name):
        return os.path.join(checkpoint_dir, name) if checkpoint_dir is not None else None

    def _have(name):
        return checkpoint_dir is not None and os.path.exists(_ck(name))

    # resuming under different settings would apply the CURRENT schedule to
    # stale state: fingerprint every setting that shapes the checkpointed
    # state and reject a mismatch
    config_fp = _np.array([dim, len(starts), mcmc_steps, mcmc_cycles, thin, K_g,
                           critical_r, inflate, pmc_dof, vb_iterations, rel_tol,
                           abs_tol], dtype=_np.float64)

    def _check_fp(path):
        with _np.load(path) as data:
            fp = data["config_fp"] if "config_fp" in data.files else None
        if fp is None or not _np.array_equal(fp, config_fp):
            raise ValueError(
                "checkpoint %s was written under a different pipeline "
                "configuration (saved %s, current %s); delete the checkpoint "
                "directory or rerun with the original settings"
                % (path, None if fp is None else fp.tolist(), config_fp.tolist()))

    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
    resumed = []

    vbmix = prior = final_mix = None
    if _have("refined_mixture.npz"):
        _check_fp(_ck("refined_mixture.npz"))
        final_mix = _checkpoint.load_mixture(_ck("refined_mixture.npz"))
        resumed = ["mcmc", "vb1", "refined"]
        say("resuming from refined proposal (K=%d)", len(final_mix))
    elif _have("vb1.npz"):
        _check_fp(_ck("vb1.npz"))
        with _np.load(_ck("vb1.npz")) as data:
            prior = {k[6:]: data[k] for k in data.files if k.startswith("prior_")}
        vbmix = _checkpoint.load_mixture(_ck("vb1_mixture.npz"))
        resumed = ["mcmc", "vb1"]
        say("resuming from VB1 fit (K=%d)", len(vbmix))
    resume_mcmc = _have("mcmc.npz")
    if mesh is not None:
        # every rank decides what it resumes before rank 0 writes a stage
        mesh.barrier()

    if final_mix is None and vbmix is None:
        # ---- 1. adaptive-MCMC chain pool
        t0 = time.perf_counter()
        sub = _sub_seed(gen)
        with annotate("mcmc"):
            if resume_mcmc:
                _check_fp(_ck("mcmc.npz"))
                with _np.load(_ck("mcmc.npz")) as data:
                    pool, rates = data["pool"], data["rates"]
                resumed = ["mcmc"]
                say("resuming from MCMC prerun (%d chains)", len(pool))
            else:
                pool, rates = _sampler.sample_adaptive_chains(
                    mcmc_target, starts.astype(_np.float64), _np.eye(dim) * 2.38 ** 2 / dim,
                    n_steps=mcmc_steps, n_adapt_cycles=mcmc_cycles, key=sub, device=device)
                pool, rates = pool.cpu().numpy(), rates.cpu().numpy()
                if checkpoint_dir is not None:
                    _checkpoint.atomic_savez(_ck("mcmc.npz"), pool=pool, rates=rates,
                                             config_fp=config_fp)
        burn = mcmc_steps * mcmc_cycles // 2
        chains = [c[burn:] for c in pool]
        details["mcmc_s"] = time.perf_counter() - t0
        details["accept_rates"] = rates[:, -1]
        say("MCMC: %d chains x %d steps (%.1f s)", len(pool), mcmc_steps * mcmc_cycles,
            details["mcmc_s"])

        # ---- 2. Gelman-Rubin grouping -> long-patches mixture
        long_patches = _mix_adapt.make_r_gaussmix(chains, K_g=K_g, critical_r=critical_r)
        details["patches_K"] = len(long_patches)

        # ---- 3. variational Bayes on the thinned pooled samples
        t0 = time.perf_counter()
        mc_samples = _np.vstack(chains)[::thin]
        with annotate("vb1"):
            vb = _mix_adapt.GaussianInference(
                mc_samples, initial_guess=long_patches, W0=_np.eye(dim) * 1e10, mesh=mesh,
                device=device)
            # never let a component fall below D+1 members: its scatter would be
            # singular and the precision overflows float32
            vb.run(vb_iterations, rel_tol=rel_tol, abs_tol=abs_tol,
                   prune=max(0.5 * vb.N / vb.K, dim + 1.0))
            vbmix = vb.make_mixture()
            prior = vb.posterior2prior()
            prior.pop("alpha0")
        details["vb1_s"] = time.perf_counter() - t0
        details["vb1_K"] = len(vbmix)
        say("VB1: %d samples -> K=%d (%.1f s)", len(mc_samples), len(vbmix), details["vb1_s"])
        if checkpoint_dir is not None:
            _checkpoint.save_mixture(_ck("vb1_mixture.npz"), vbmix)
            _checkpoint.atomic_savez(_ck("vb1.npz"), config_fp=config_fp,
                                     **{"prior_" + k: v for k, v in prior.items()})

    def importance_sampler(proposal):
        if mesh is None:
            return _sampler.ImportanceSampler(log_target, proposal, rng=_sub_seed(gen),
                                              device=device)
        return ParallelSampler(log_target, proposal, mesh=mesh, rng=_sub_seed(gen))

    run1_proposal = None
    if final_mix is None:
        # ---- 4. inflated first IS run + weighted-VB refinement: on the
        # device in one process, gathered to every rank's host on a mesh
        mi, ci, wi = _density.recover_gaussian_mixture(vbmix)
        vbmix_wide = _density.create_gaussian_mixture(mi, inflate * ci, wi)
        sampler = importance_sampler(vbmix_wide)
        t0 = time.perf_counter()
        with annotate("is1_vb2"):
            sampler.run(-(-n_is1 // n_dev), to_host=mesh is not None)
            if mesh is None:
                sT1, w1 = sampler.device_runs[0]
                vb2_data, vb2_w = sT1.T, w1
            else:
                vb2_data, vb2_w = sampler.samples[:], sampler.weights[:][:, 0]
            # a float32 overflow w = exp(log p - log q) = inf would NaN-poison VB2
            if not bool(torch.isfinite(torch.sum(torch.as_tensor(vb2_w)))):
                raise ValueError("importance weights contain inf/nan (float32 overflow "
                                 "in exp(log p - log q)?)")
            vb2 = _mix_adapt.GaussianInference(vb2_data, initial_guess=vbmix, weights=vb2_w,
                                               mesh=mesh, device=device, **prior)
            vb2.run(vb_iterations, rel_tol=rel_tol, abs_tol=abs_tol)
            vb2mix = vb2.make_mixture()
        details["is1_vb2_s"] = time.perf_counter() - t0
        details["vb2_K"] = len(vb2mix)

        # ---- 5. Student-t M-PMC refinement
        t0 = time.perf_counter()
        m2, c2, w2 = _density.recover_gaussian_mixture(vb2mix)
        pmc_mix = _density.create_t_mixture(
            m2, c2 * (pmc_dof - 2.0) / pmc_dof, _np.full(len(w2), pmc_dof), w2)
        with annotate("pmc"):
            if pmc_steps > 0 and mesh is not None:
                final_mix, details["pmc_perplexity_curve"] = _refine_sharded(
                    pmc_mix.stacked_params(dtype=dtype, device=device), mcmc_target, gen,
                    n_is1, pmc_steps, pmc_weight_clip, mesh)
                if final_mix is None:
                    # every component died (extremely skewed weights at high D):
                    # keep the un-refined heavy-tailed proposal
                    logger.warning("PMC refinement killed every component; keeping the "
                                   "pre-refinement proposal")
                    final_mix = pmc_mix
            elif pmc_steps > 0 and target_params is not None:
                final_mix, details["pmc_perplexity_curve"] = _refine_mixture_target(
                    pmc_mix.stacked_params(dtype=dtype, device=device), target_params, gen,
                    n_is1, pmc_steps, pmc_weight_clip)
            elif pmc_steps > 0:
                # generic callable target: PMC on stored IS samples through the
                # reference-protocol driver
                s2 = _sampler.ImportanceSampler(log_target, pmc_mix, rng=_sub_seed(gen),
                                                device=device)
                for _ in range(pmc_steps):
                    s2.run(n_is1)
                    w_run = s2.weights[-1][:, 0]
                    if pmc_weight_clip:
                        w_run = _np.minimum(w_run, w_run.mean() * _np.sqrt(float(len(w_run))))
                    pmc = _mix_adapt.PMC(s2.samples[-1], s2.proposal, weights=w_run,
                                         device=device)
                    pmc.run(1)
                    s2.proposal = pmc.density
                final_mix = s2.proposal
            else:
                final_mix = pmc_mix
        details["pmc_s"] = time.perf_counter() - t0
        details["final_K"] = len(final_mix)
        say("PMC refinement: K=%d live (%.1f s)", len(final_mix), details["pmc_s"])
        run1_proposal = vbmix_wide
        if checkpoint_dir is not None:
            _checkpoint.save_mixture(_ck("refined_mixture.npz"), final_mix,
                                     extra={"config_fp": config_fp})
    else:
        # resumed from the refined proposal: only the final sampling stage
        # runs, and the estimate uses that run alone
        sampler = importance_sampler(final_mix)
        details["final_K"] = len(final_mix)

    # ---- 6. final IS run, deterministic-mixture combination, estimate
    t0 = time.perf_counter()
    with annotate("is2_combine"):
        sampler.proposal = final_mix
        sampler.run(-(-n_is2 // n_dev), to_host=mesh is not None)
        proposals = [final_mix] if run1_proposal is None else [run1_proposal, final_mix]
        if mesh is None:
            runs = [(sT.T, w) for sT, w in sampler.device_runs]
        else:
            runs = [(sampler.samples[i], sampler.weights[i][:, 0])
                    for i in range(len(proposals))]
        weights = _sampler.combine_weights([s for s, _ in runs], [w for _, w in runs],
                                           proposals, device=device)[:][:, 0]
    details["is2_combine_s"] = time.perf_counter() - t0
    details["resumed_stages"] = resumed
    samples = None
    if return_samples:
        sampler.gather()
        samples = sampler.samples[:]

    evidence = weights.sum() / len(weights)
    uncertainty = _np.sqrt((weights ** 2).sum() / len(weights) - evidence ** 2) \
        / _np.sqrt(len(weights) - 1)
    details["total_s"] = time.perf_counter() - t_all
    return IntegrateResult(
        evidence=float(evidence),
        uncertainty=float(uncertainty),
        perplexity=float(_tools.perp(weights)),
        ess=float(_tools.ess(weights)),
        proposal=final_mix,
        n_samples=int(len(weights)),
        samples=samples,
        weights=weights,
        details=details,
    )


def _refine_sharded(pparams, target, gen, n, steps, weight_clip, mesh):
    """The Student-t M-PMC refinement over a particle mesh:
    :func:`~pypmc_tpu_torch.parallel.pmc_run_sharded` of ``steps`` steps of
    ``n`` particles in all.  Returns the live components as a host mixture
    (None if none lived) and the normalized perplexity of each step."""
    pparams, stats = pmc_run_sharded(block_target(target), pparams, n, steps, mesh=mesh,
                                     key=_sub_seed(gen), weight_clip=weight_clip)
    host = {f: getattr(pparams, f).double().cpu().numpy()
            for f in ("means", "cov", "dof", "weights")}
    live = host["weights"] > 0
    curve = [float(x) for x in stats.perplexity.double().cpu().numpy()]
    if not live.any():
        return None, curve
    return (_density.create_t_mixture(host["means"][live], host["cov"][live],
                                      host["dof"][live], host["weights"][live]), curve)


def _refine_mixture_target(pparams, target_params, gen, n, steps, weight_clip):
    """The Student-t M-PMC refinement against a mixture target: ``steps``
    updates of ``n`` particles each, on the clipped weights (draw and
    evaluation one ``fused_propose_logq`` launch, then the update) or in
    one ``fused_is_pmc_step`` launch a step.  Returns the live components as
    a host mixture and the normalized perplexity of each step."""
    perp_curve = []
    for _ in range(steps):
        sub = _sub_seed(gen)
        if weight_clip:
            # truncated at mean * sqrt(n) (Ionides 2008), so that a lone
            # tail spike cannot starve the statistics
            samples_T, _, log_q, log_p = _core.propose_logq_T(pparams, sub, n, target_params)
            w = torch.exp(log_p - log_q)
            w_adapt = torch.minimum(w, torch.mean(w) * float(n) ** 0.5)
            result = pmc_update(pparams, samples_T, w_adapt, transposed=True,
                                dof_solver_steps=100)
            sw = torch.stack([torch.sum(w), torch.sum(w * w),
                              torch.sum(torch.special.xlogy(w, w))])
        else:
            result, _, _, _, sw = pmc_step_mixture_target(pparams, target_params, sub, n)
        sw = sw.double().cpu().numpy()      # one host sync a step
        if not bool((result.params.weights > 0).any()):
            # a step that kills every component cannot be used
            logger.warning("PMC refinement step killed every component; stopping at "
                           "the last live proposal")
            break
        pparams = result.params
        perp_curve.append(float(_np.exp(-(sw[2] / sw[0]) + _np.log(sw[0])) / n))
    host = {f: getattr(pparams, f).double().cpu().numpy()
            for f in ("means", "cov", "dof", "weights")}
    live = host["weights"] > 0
    return (_density.create_t_mixture(host["means"][live], host["cov"][live],
                                      host["dof"][live], host["weights"][live]),
            perp_curve)
