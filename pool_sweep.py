"""Time both variants of fused_mcmc_pool, a thread a chain and a warp a
chain, over a grid of pools (C chains in D dimensions, 100 steps, the
2-component highdim_target of chip_smoke.py): the measurements that place
the cut-offs of csrc/mcmc_pool.cu pool_warp_chains (mirrored by
ops/_build.py _POOL_WARP_CHAINS).  Needs one CUDA card:

    python3 pool_sweep.py > sweep.txt

Prints one line a pool, ``D= C= thread <ms> warp <ms> elected <variant>``
(CUDA events, a launch's mean over 5 after 2 warm-ups), then the grid as
one JSON list of ``[D, C, thread ms, warp ms]``.
"""

import json
import sys

import chip_smoke

GRID_D = (4, 8, 16, 20, 24, 32, 33, 40, 48, 64)
GRID_C = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


def main():
    import torch

    if not torch.cuda.is_available():
        print("pool_sweep: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from pypmc_tpu_torch.ops import _build

    _build.load()
    device = torch.device("cuda", 0)
    rows = []
    for D in GRID_D:
        for C in GRID_C:
            ms = chip_smoke.pool_shape_ms(device, (C, 2, D, 100), plain=False)
            rows.append([D, C, ms["thread"], ms["warp"]])
            print("D=%2d C=%6d thread %.4f warp %.4f elected %s"
                  % (D, C, ms["thread"], ms["warp"], _build.pool_variant(C, D)), flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
