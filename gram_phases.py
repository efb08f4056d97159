#!/usr/bin/env python3
"""Where the Gram statistics pass (``pypmc_tpu_torch/csrc/gram_stats.cuh``)
spends its time, on one GPU.

    python3 gram_phases.py            # each phase's cost
    python3 gram_phases.py --ablate   # the whitening's warp pairing
    python3 gram_phases.py --vb       # either, of fused_vb_estep's VB mode

Builds ``pmc_stats.cu`` (with ``--vb``: ``vb_estep.cu``) under
``build/gram_phases/`` once for each variant (one ``nvcc`` each, all at
once), each with parts of the pass left out by the kernel's
``PMC_GRAM_OFF`` mask (``GramOff`` in gram_stats.cuh; 0, the whole pass, in
the library), and times ``fused_pmc_stats``' Gram pass (``fused_vb_estep``'s
on the proposal's VB operands, ``chip_smoke.vb_operands``) on its inputs at
2^20 particles (CUDA events).  The outputs of a variant with a part left
out are not checked (they are wrong by design).

Phases (A the whitening, B the per-particle densities, C the weighted SYRK,
F the slices' join and the float64 flush, S the scalar sums, X the particle
tile's copies; "none" all of them): each variant in turns, all of them then
in reverse, the mean of the two; a phase's cost is the whole pass's time
less the time without it.  Without F the compiler also drops C's sums,
which nothing reads then, so F's own cost is (all - no F) - (all - no C).

Ablate: the whole pass against the pass without the whitening's pairing
of warps on a scheduler ("no pair"), in ``PAIRS`` alternating pairs (all,
v, v, all) at every ``chip_smoke.GRAM_SHAPES`` entry; prints each mean and
the pairs the whole pass won.

Needs the kernel library (``pypmc_tpu_torch.ops._build``) and the card;
prints one line a shape.
"""

import ctypes
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "gram_phases"
SHAPES = [(7, 17), (4, 32), (1, 65), (1, 128)]
N = 1 << 20
PAIRS = 5
# csrc/gram_stats.cuh GramOff
OFF = {"X": 1, "A": 2, "B": 4, "S": 8, "C": 16, "F": 32, "pair": 64}
PHASES = "ABCFSX"


def variants(ablate):
    """``{name: PMC_GRAM_OFF mask}``."""
    if ablate:
        return {"all": 0, "no pair": OFF["pair"]}
    out = {"all": 0}
    out.update({"no" + p: OFF[p] for p in PHASES})
    out["none"] = sum(OFF[p] for p in PHASES)
    return out


def build(masks, source):
    """``{variant: the kernel's launcher}``: csrc/<source>.cu (pmc_stats or
    vb_estep) with each mask, one nvcc a variant, all at once."""
    from pypmc_tpu_torch.ops import _build

    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    paths = {name: OUT / ("lib_%d.so" % mask) for name, mask in masks.items()}
    log, rc = _build._run_all(
        [[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-DPMC_GRAM_OFF=%d" % masks[name],
          "-o", str(path), str(_build.CSRC / (source + ".cu"))]
         for name, path in paths.items()])
    if rc != 0:
        raise SystemExit("gram_phases: nvcc failed:\n%s" % log[-4000:])
    argtypes = _build.signatures()["pmc_fused_" + source]
    libs = {}
    for name, path in paths.items():
        fn = getattr(ctypes.CDLL(str(path)), "pmc_fused_" + source)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    ablate, vb = "--ablate" in argv, "--vb" in argv
    if set(argv) - {"--ablate", "--vb"}:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("gram_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from pypmc_tpu_torch.ops import _build
    from pypmc_tpu_torch.ops import kernels as k

    print(c.card_line())
    masks = variants(ablate)
    libs = build(masks, "vb_estep" if vb else "pmc_stats")
    lib = _build.load()
    device = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream
    for K, D in c.GRAM_SHAPES if ablate else SHAPES:
        ops, tops, _, _, _, params = c.gram_mixtures((K, 1, D, N, True, False, True, K + D),
                                                     device)
        xT, _, log_q, log_p = k.fused_propose_logq((7, 7), ops, N, tops)
        w = torch.exp(log_p - log_q)
        per_sm = lib.pmc_vb_estep_per_sm(K, D) if vb else lib.pmc_pmc_stats_per_sm(K, D)
        n_blocks = min(-(-N // 64), per_sm * n_sm)
        E = k._entries(K, D)
        partial = torch.empty((n_blocks, E), dtype=torch.float64, device=device)
        flat = torch.empty((E,), dtype=torch.float64 if vb else torch.float32, device=device)
        operands = (torch.cat([v.reshape(-1) for v in c.vb_operands(params)]) if vb
                    else ops.packed)
        # fused_vb_estep's launcher takes no student_t and dof_stats
        flags = () if vb else (1, 1)

        def call(fn):
            err = fn(xT.data_ptr(), w.data_ptr(), operands.data_ptr(), partial.data_ptr(),
                     flat.data_ptr(), N, K, D, *flags, 2, n_blocks, stream)
            if err != 0:
                raise SystemExit("gram_phases: CUDA error %d" % err)

        timed = lambda name: c.cuda_ms(lambda i, fn=libs[name]: call(fn), reps=10)
        head = ("%s K=%d D=%d N=%d, %d blocks of 256 threads (%d an SM)"
                % ("fused_vb_estep" if vb else "fused_pmc_stats", K, D, N, n_blocks, per_sm))
        if ablate:
            parts = []
            for name in list(masks)[1:]:
                ms = {"all": [], name: []}
                for _ in range(PAIRS):
                    for v in ("all", name, name, "all"):
                        ms[v].append(timed(v))
                won = sum(a + b < x + y for a, x, y, b in
                          zip(ms["all"][::2], ms[name][::2], ms[name][1::2], ms["all"][1::2]))
                parts.append("%s %.4f against %.4f, the whole pass faster in %d of %d pairs"
                             % (name, sum(ms[name]) / len(ms[name]),
                                sum(ms["all"]) / len(ms["all"]), won, PAIRS))
            print("%s: %s" % (head, "; ".join(parts)), flush=True)
            continue
        ms = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                ms[name].append(timed(name))
        mean = {name: sum(v) / len(v) for name, v in ms.items()}
        cost = {p: mean["all"] - mean["no" + p] for p in PHASES}
        cost["F"] -= cost["C"]
        print("%s: the pass %.3f ms; without each phase %s; each phase's cost %s; the walk "
              "alone %.3f ms"
              % (head, mean["all"], ", ".join("%s %.3f" % (p, mean["no" + p]) for p in PHASES),
                 ", ".join("%s %.3f" % (p, cost[p]) for p in PHASES), mean["none"]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
