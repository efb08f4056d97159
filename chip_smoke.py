#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``pypmc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the four CUDA kernels from ``pypmc_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the flagship shapes (K=10 Student-t proposal, K_target=2, D=10,
   N=2^20) and at the edges (K=1, D=1, D=7, odd N, a dead component,
   Gaussian and Student-t proposal and target).  The random kernels are
   checked on their own samples: the plain version recomputes every
   deterministic output from them, and the samples' moments, component
   frequencies, seed determinism and dead components are tested;
4. slice: ``pmc_run_sharded`` at the ``examples/pmc_large_scale.py``
   configuration (10^7 particles a step, 10 steps), then 2 steps with
   ``weight_clip=True``, with the kernels' launch counts read around the
   two runs;
5. times: each kernel and its plain version, with CUDA events.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

N_FLAGSHIP = 1 << 20
N_ODD = 1_000_003
N_SLICE = 10_000_000
STEPS = 10
N_PLAIN_MAX = 1 << 22   # a plain version's (K D, N) intermediates grow with N
N_BENCH = 1 << 26       # bench.py's batch for the propose step
SOURCES = {
    "fused_logq": ("pypmc_tpu_torch/csrc/logq.cu", "pypmc_tpu/ops/pallas_kernels.py:788"),
    "fused_propose_logq": ("pypmc_tpu_torch/csrc/propose_logq.cu",
                           "pypmc_tpu/ops/pallas_kernels.py:924"),
    "fused_pmc_stats": ("pypmc_tpu_torch/csrc/pmc_stats.cu",
                        "pypmc_tpu/ops/pallas_kernels.py:1150"),
    "fused_is_pmc_step": ("pypmc_tpu_torch/csrc/is_pmc_step.cu",
                          "pypmc_tpu/ops/pallas_kernels.py:1336"),
}
# |kernel - plain| <= ATOL + RTOL * max|plain| per output; the plain
# version runs in float64 on the kernel's float32 inputs, so the bound is
# the kernel's own float32 rounding
TOL = {"log": (2e-3, 1e-5), "w": (0.0, 1e-3), "stats": (1e-6, 1e-4),
       "update": (1e-4, 1e-3), "dof": (0.0, 1e-2)}


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync(device):
    """Bring a fault of a launch to light where it happened."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


# --------------------------------------------------------------------- #
# problem construction                                                  #
# --------------------------------------------------------------------- #

def random_mixture(rng, K, D, student_t, dead=False, spread=2.0):
    """(means, covs, weights, dofs) as float32 numpy arrays."""
    means = rng.normal(0, spread, (K, D))
    a = rng.normal(0, 0.3, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    if dead:
        w[K // 2] = 0.0
    w = w / w.sum()
    dofs = rng.uniform(6.0, 12.0, K) if student_t else None
    cast = lambda v: None if v is None else v.astype(np.float32)
    return cast(means), cast(covs), cast(w), cast(dofs)


def make_params(arrs, device):
    import torch
    from pypmc_tpu_torch.density import core

    means, covs, w, dofs = arrs
    params, valid = core.make_mixture(
        torch.tensor(means, device=device), torch.tensor(covs, device=device),
        torch.tensor(w, device=device),
        None if dofs is None else torch.tensor(dofs, device=device))
    require(bool(valid.all()), "test mixture is not positive definite")
    return params


def flagship_problem(device):
    """The examples/pmc_large_scale.py configuration in float32."""
    K, D = 10, 10
    rng = np.random.default_rng(0)
    t_means = np.stack([rng.normal(0, 1, D), rng.normal(0, 1, D) + 3.0]).astype(np.float32)
    t_covs = np.array([np.eye(D) * 0.8, np.eye(D) * 1.2]).astype(np.float32)
    means = rng.normal(1.5, 3.0, size=(K, D)).astype(np.float32)
    covs = np.array([np.eye(D) * 6.0] * K).astype(np.float32)
    dofs = np.full((K,), 8.0, dtype=np.float32)
    target = make_params((t_means, t_covs, np.array([0.3, 0.7], np.float32), None), device)
    params = make_params((means, covs, np.full((K,), 0.1, np.float32), dofs), device)
    return params, target, t_means


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions                         #
# --------------------------------------------------------------------- #

def compare(name, got, ref, kind, report):
    """|got - ref| <= atol + rtol * max|ref|; records and prints the error."""
    import torch

    atol, rtol = TOL[kind]
    got = got.double()
    require(bool(torch.isfinite(got).all()), "%s: non-finite kernel output" % name)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    bound = atol + rtol * scale
    print("  %-34s max_abs_err %.3e  tol %.3e" % (name, err, bound))
    report.append({"output": name, "max_abs_err": err, "tol": bound})
    require(err <= bound, "%s: error %.3e above tolerance %.3e" % (name, err, bound))


def mixture_moments(arrs):
    """Mean and covariance of a Gaussian / Student-t mixture."""
    means, covs, w, dofs = [None if a is None else a.astype(np.float64) for a in arrs]
    scale = np.ones_like(w) if dofs is None else dofs / (dofs - 2.0)
    mean = w @ means
    second = np.einsum("k,kij->ij", w, covs * scale[:, None, None]
                       + np.einsum("ki,kj->kij", means, means))
    return mean, second - np.outer(mean, mean)


def check_samples(name, xT, latent, arrs, report):
    """Moments against the mixture's (6 sigma Monte Carlo bounds),
    component frequencies against the weights (chi-square test), and no
    draw of a dead component."""
    from scipy import stats as st

    x = xT.double().cpu().numpy()
    lat = latent.cpu().numpy()
    w = arrs[2].astype(np.float64)
    K, N = len(w), x.shape[1]
    counts = np.bincount(lat, minlength=K)
    require(counts.shape[0] == K, "%s: latent outside [0, K)" % name)
    require(np.all(counts[w == 0] == 0), "%s: a dead component was drawn" % name)
    live = w > 0
    if live.sum() > 1:
        chi2 = float(np.sum((counts[live] - N * w[live]) ** 2 / (N * w[live])))
        p = float(st.chi2.sf(chi2, live.sum() - 1))
        print("  %-34s chi2 %.2f  p %.3g" % (name + " latent", chi2, p))
        require(p > 1e-6, "%s: component frequencies off (p=%.3g)" % (name, p))
    mean, cov = mixture_moments(arrs)
    m = x.mean(axis=1)
    xc = x - m[:, None]
    c = xc @ xc.T / N
    se_m = np.sqrt(np.diag(c) / N)
    prod = xc[:, None, :] * xc[None, :, :] if x.shape[0] <= 10 else None
    se_c = (prod.std(axis=2) / math.sqrt(N) if prod is not None
            else np.sqrt(np.outer(np.diag(c), np.diag(c)) * 3.0 / N))
    zm = float(np.max(np.abs(m - mean) / se_m))
    zc = float(np.max(np.abs(c - cov) / se_c))
    print("  %-34s mean %.2f sigma  cov %.2f sigma" % (name + " moments", zm, zc))
    require(zm < 6 and zc < 6, "%s: sample moments off (%.2f, %.2f sigma)" % (name, zm, zc))
    report.append({"output": name + " moments", "mean_sigma": zm, "cov_sigma": zc})


def check_stats(prefix, got, ref, n, report):
    """The statistics per particle (divided by N), so that the bounds do
    not grow with N."""
    for key in ("s0", "s0c", "sd", "g", "sw", "t1"):
        compare("%s %s/N" % (prefix, key), got[key] / n, ref[key] / n, "stats", report)


def kernel_case(case, device, report):
    """Run all four kernels on one mixture configuration."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    K, Kt, D, N, student, t_student, dead, seed = case
    rng = np.random.default_rng(seed)
    arrs = random_mixture(rng, K, D, student, dead)
    tarrs = random_mixture(rng, Kt, D, t_student, spread=1.0)
    params, target = make_params(arrs, device), make_params(tarrs, device)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    ops64 = k.MixtureOperands(ops.packed.double(), K, D, student)
    tops64 = k.MixtureOperands(tops.packed.double(), Kt, D, t_student)
    tag = "K=%d Kt=%d D=%d N=%d %s%s" % (K, Kt, D, N, "t" if student else "gauss",
                                         " dead" if dead else "")
    print("case", tag)

    # fused_propose_logq: its own samples, recomputed by the plain version
    seed_a, seed_b = (seed, 11), (seed, 12)
    xT, lat, log_q, log_p = k.fused_propose_logq(seed_a, ops, N, tops)
    sync(device)
    x64 = xT.double()
    compare("fused_propose_logq log_q", log_q, k.plain_logq(x64, ops64), "log", report)
    compare("fused_propose_logq log_p", log_p, k.plain_logq(x64, tops64), "log", report)
    check_samples("fused_propose_logq", xT, lat, arrs, report)
    again = k.fused_propose_logq(seed_a, ops, N, tops)
    require(all(bool(torch.equal(a, b)) for a, b in zip((xT, lat, log_q, log_p), again)),
            "fused_propose_logq: one seed gave two outputs")
    other = k.fused_propose_logq(seed_b, ops, N, tops)[0]
    require(not bool(torch.equal(other, xT)), "fused_propose_logq: two seeds, one output")
    del again, other

    # fused_logq on the same points
    compare("fused_logq", k.fused_logq(xT, ops), k.plain_logq(x64, ops64), "log", report)

    # fused_pmc_stats on identical inputs
    w = torch.exp(log_p - log_q)
    dof_stats = student
    got = k.fused_pmc_stats(xT, w, ops, dof_stats)
    ref = k.plain_pmc_stats(x64, w.double(), ops64, dof_stats)
    check_stats("fused_pmc_stats", got, ref, N, report)
    del w, got, ref, x64, xT, lat, log_q, log_p

    # fused_is_pmc_step: its own samples, recomputed by the plain version
    xT, lat, w, got = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats)
    sync(device)
    x64 = xT.double()
    w_ref = torch.exp(k.plain_logq(x64, tops64) - k.plain_logq(x64, ops64))
    compare("fused_is_pmc_step w", w, w_ref, "w", report)
    check_stats("fused_is_pmc_step", got,
                k.plain_pmc_stats(x64, w_ref, ops64, dof_stats, n_sw=3), N, report)
    check_samples("fused_is_pmc_step", xT, lat, arrs, report)
    again = k.fused_is_pmc_step(seed_a, ops, tops, N, dof_stats)
    require(bool(torch.equal(again[0], xT)) and bool(torch.equal(again[3]["g"], got["g"])),
            "fused_is_pmc_step: one seed gave two outputs")
    require(not bool(torch.equal(k.fused_is_pmc_step(seed_b, ops, tops, N, dof_stats)[0], xT)),
            "fused_is_pmc_step: two seeds, one output")


KERNEL_CASES = [
    # K, Kt, D, N, Student-t proposal, Student-t target, dead component, seed
    (10, 2, 10, N_FLAGSHIP, True, False, False, 1),
    (10, 2, 10, N_ODD, False, True, True, 2),
    (1, 1, 1, N_ODD, True, False, False, 3),
    (1, 2, 5, N_ODD, False, False, False, 4),
    (4, 2, 7, N_ODD, True, True, True, 5),
    (3, 1, 1, N_FLAGSHIP, False, True, False, 6),
]


def phase_kernels(device, cases):
    import torch
    from pypmc_tpu_torch.ops import kernels as k

    report = []
    for case in cases:
        kernel_case(case, device, report)
        torch.cuda.empty_cache()
    # a CUDA tensor of another dtype never reaches a plain version
    params, _, _ = flagship_problem(device)
    from pypmc_tpu_torch.density import core
    ops = core._kernel_operands(params)
    ops64 = k.MixtureOperands(ops.packed.double(), ops.K, ops.dim, ops.student_t)
    try:
        k.fused_logq(torch.zeros((10, 256), dtype=torch.float64, device=device), ops64)
    except TypeError:
        print("  float64 CUDA input to fused_logq raises TypeError: ok")
    else:
        raise SmokeFailure("fused_logq accepted a float64 CUDA tensor")
    return report


# --------------------------------------------------------------------- #
# phase 4: the slice                                                    #
# --------------------------------------------------------------------- #

def slice_reference(device, report):
    """One step of the slice on the card against the unfused update in
    float64 on the CPU, on the step's own samples and weights."""
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.mix_adapt.pmc import pmc_step_mixture_target, pmc_update

    params, target, _ = flagship_problem(device)
    result, xT, w, _, _ = pmc_step_mixture_target(params, target, 5, 1 << 18)
    p64, t64 = params.to("cpu", torch.float64), target.to("cpu", torch.float64)
    x64 = xT.cpu().double()
    w64 = torch.exp(core.mixture_logpdf_T(t64, x64) - core.mixture_logpdf_T(p64, x64))
    compare("slice step w", w.cpu(), w64, "w", report)
    ref = pmc_update(p64, x64, w64, transposed=True, fused="off").params
    got = result.params.to("cpu")
    for f in ("means", "cov", "weights"):
        compare("slice step " + f, getattr(got, f), getattr(ref, f), "update", report)
    compare("slice step dof", got.dof, ref.dof, "dof", report)


def phase_slice(device):
    import torch
    from pypmc_tpu_torch.ops import kernels as k
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    params, target, t_means = flagship_problem(device)
    # warm-up (not counted, not timed): first-use allocations
    pmc_run_sharded(target, params, N_SLICE, 1, key=100)
    torch.cuda.synchronize()

    k.reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = pmc_run_sharded(target, params, N_SLICE, STEPS, key=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out_c, stats_c = pmc_run_sharded(target, params, N_SLICE, 2, key=1, weight_clip=True)
    torch.cuda.synchronize()
    counts = k.launch_counts()

    s = {f: getattr(stats, f).double().cpu().numpy() for f in stats._fields}
    sc = {f: getattr(stats_c, f).double().cpu().numpy() for f in stats_c._fields}
    for i in range(STEPS):
        print("  step %2d  ess %.4f  perplexity %.4f  evidence %.6f  loglik %.4f"
              % (i + 1, s["ess"][i], s["perplexity"][i], s["evidence"][i],
                 s["log_likelihood"][i]))
    print("  weight_clip run: ess %s  evidence %s" % (np.round(sc["ess"], 4),
                                                      np.round(sc["evidence"], 6)))
    w = out.weights.double().cpu().numpy()
    mu = out.means.double().cpu().numpy()
    masses = [float(w[np.linalg.norm(mu - t_means[j], axis=1) < 3].sum()) for j in (0, 1)]
    print("  mode masses %s (target [0.3, 0.7])" % np.round(masses, 4))
    print("  launch counts %s" % json.dumps(counts))
    print("  10 steps of %d particles: %.1f ms a step (host clock, synchronized)"
          % (N_SLICE, dt / STEPS * 1e3))

    finite = all(np.isfinite(v).all() for d in (s, sc) for v in d.values())
    finite = finite and all(bool(torch.isfinite(t).all()) for t in
                            (out.means, out.cov, out.weights, out.dof))
    require(finite, "slice: NaN or inf in the statistics or the mixture")
    ev_err = np.abs(s["evidence"][1:] - 1.0)
    require(np.all(ev_err < 0.01), "slice: evidence off by %s" % ev_err)
    # the clipped run has only 2 steps from the wide initial proposal, where
    # the ESS is still small: hold its evidence to 5 Monte Carlo sigma
    sigma = sc["evidence"] * np.sqrt((1.0 / sc["ess"] - 1.0) / N_SLICE)
    require(np.all(np.abs(sc["evidence"] - 1.0) < 5 * sigma + 1e-3),
            "slice: clipped-run evidence %s off by more than 5 sigma %s"
            % (sc["evidence"], sigma))
    require(s["ess"][-1] >= 0.8, "slice: last-step ESS %.4f < 0.8" % s["ess"][-1])
    require(abs(masses[0] - 0.3) < 0.05 and abs(masses[1] - 0.7) < 0.05,
            "slice: mode masses %s" % masses)
    require(counts["fused_is_pmc_step"] == STEPS, "slice: fused_is_pmc_step launches")
    require(counts["fused_logq"] >= STEPS, "slice: fused_logq launches")
    require(counts["fused_propose_logq"] >= 2, "slice: fused_propose_logq launches")
    require(counts["fused_pmc_stats"] >= 2, "slice: fused_pmc_stats launches")
    return counts, dt / STEPS * 1e3, out


def profile_slice(device, step_ms, steps=2):
    """Device time of the slice's steps by kernel (torch.profiler), and its
    share of the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pypmc_tpu_torch.parallel import pmc_run_sharded

    params, target, _ = flagship_problem(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pmc_run_sharded(target, params, N_SLICE, steps, key=3)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print("  device time a step %.3f ms = %.1f%% of the %.1f ms step; %d launches a step"
          % (busy, 100 * busy / step_ms, step_ms, sum(r[1] for r in rows)))
    for ms, count, key in rows[:8]:
        print("    %8.3f ms  %5.0f x  %s" % (ms, count, key[:90]))
    return busy


def time_solve_dofs(device, reps=20):
    """Milliseconds of the host-driven dof bisection for K = 10."""
    import torch
    from pypmc_tpu_torch.mix_adapt.pmc import _solve_dofs

    const = torch.linspace(-0.5, -0.01, 10, device=device)
    dofs = torch.full((10,), 8.0, device=device)
    _solve_dofs(const, dofs, 100, 1e-5, 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        _solve_dofs(const, dofs, 100, 1e-5, 1e3)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# --------------------------------------------------------------------- #
# phase 5: times                                                        #
# --------------------------------------------------------------------- #

def cuda_ms(fn, reps=10, warmup=2):
    """Mean milliseconds of fn(i) over ``reps`` calls, CUDA events; each
    call gets its own index (distinct seeds)."""
    import torch

    for i in range(warmup):
        fn(10_000 + i)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_times(device):
    import torch
    from pypmc_tpu_torch.density import core
    from pypmc_tpu_torch.ops import kernels as k

    params, target, _ = flagship_problem(device)
    ops, tops = core._kernel_operands(params), core._kernel_operands(target)
    times = {}

    def pair(name, kernel, plain, sizes):
        for n in sizes:
            times[(name, n, "cuda")] = cuda_ms(lambda i: kernel(i, n))
        times[(name, N_PLAIN_MAX, "plain")] = cuda_ms(lambda i: plain(i, N_PLAIN_MAX), reps=3, warmup=1)

    xs, ws = {}, {}
    for n in (N_PLAIN_MAX, N_SLICE):
        xs[n], _, log_q, log_p = k.fused_propose_logq((7, 7), ops, n, tops)
        ws[n] = torch.exp(log_p - log_q)
    pair("fused_logq", lambda i, n: k.fused_logq(xs[n], ops),
         lambda i, n: k.plain_logq(xs[n], ops), (N_PLAIN_MAX, N_SLICE))
    pair("fused_pmc_stats", lambda i, n: k.fused_pmc_stats(xs[n], ws[n], ops, True),
         lambda i, n: k.plain_pmc_stats(xs[n], ws[n], ops, True), (N_PLAIN_MAX, N_SLICE))
    del xs, ws, log_q, log_p
    torch.cuda.empty_cache()
    pair("fused_propose_logq", lambda i, n: k.fused_propose_logq((i, 1), ops, n, tops),
         lambda i, n: k.plain_propose_logq((i, 1), ops, n, tops),
         (N_PLAIN_MAX, N_SLICE, N_BENCH))
    torch.cuda.empty_cache()
    pair("fused_is_pmc_step", lambda i, n: k.fused_is_pmc_step((i, 2), ops, tops, n, True),
         lambda i, n: k.plain_is_pmc_step((i, 2), ops, tops, n, True),
         (N_PLAIN_MAX, N_SLICE))
    for (name, n, route), ms in times.items():
        print("  %-20s %-6s N=%-9d %9.3f ms" % (name, route, n, ms))
    return times


# --------------------------------------------------------------------- #

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        import pypmc_tpu_torch  # noqa: F401
        from pypmc_tpu_torch.ops import _build
        from pypmc_tpu_torch.ops import kernels as k
    except ImportError as e:
        print("chip_smoke: the package is not beside this script: %s" % e, file=sys.stderr)
        return 2
    require("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print("phase device: %s | torch %s cuda %s | %s" % (card, torch.__version__,
                                                          torch.version.cuda, name))

    t0 = time.perf_counter()
    lib = _build.load()
    print("phase build: %.1f s (%s, %s)" % (time.perf_counter() - t0,
                                            _build.build_info.get("path"),
                                            "built" if _build.build_info.get("built") else "cached"))
    log = _build.build_info.get("log", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
    if regs:
        print("  ptxas: %d kernels, %d-%d registers a thread, %d bytes of spill stores"
              % (len(regs), min(regs), max(regs), spills))
    for K, Kt, D in ((10, 2, 10), (1, 1, 1), (4, 2, 7), (3, 1, 32)):
        for kernel, step in (("fused_pmc_stats", 0), ("fused_is_pmc_step", 1)):
            c = lib.pmc_stats_smem_bytes(K, Kt, D, step)
            require(c == _build.smem_bytes(kernel, K, D, Kt),
                    "shared-memory formula differs from the kernel's (%s)" % kernel)

    print("phase kernels:")
    report = phase_kernels(device, KERNEL_CASES)

    print("phase slice:")
    slice_reference(device, report)
    counts, step_ms, out = phase_slice(device)
    require(tuple(out.means.shape) == (10, 10) and tuple(out.cov.shape) == (10, 10, 10),
            "slice: adapted mixture of the wrong shape")
    busy_ms = profile_slice(device, step_ms)
    dofs_ms = time_solve_dofs(device)
    print("  _solve_dofs alone (K=10, 100 bisection steps, host clock): %.3f ms, "
          "%.1f%% of a step" % (dofs_ms, 100 * dofs_ms / step_ms))

    print("phase times (%s):" % card)
    times = phase_times(device)

    kernels = []
    for kname, (src, replaces) in SOURCES.items():
        worst = max((r for r in report if "max_abs_err" in r and (
            r["output"] == kname or r["output"].startswith(kname + " "))),
            key=lambda r: r["max_abs_err"] / r["tol"])
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[kname], "max_abs_err": worst["max_abs_err"],
            "max_abs_err_tol": worst["tol"], "max_abs_err_output": worst["output"],
            "ms": times[(kname, N_PLAIN_MAX, "cuda")],
            "plain_ms": times[(kname, N_PLAIN_MAX, "plain")], "n": N_PLAIN_MAX,
            "ms_slice_n": times[(kname, N_SLICE, "cuda")], "slice_n": N_SLICE,
        })
    print("ms and plain_ms at N=%d, ms_slice_n at N=%d; max_abs_err is |kernel - plain| "
          "of the kernel's check nearest its tolerance" % (N_PLAIN_MAX, N_SLICE))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
