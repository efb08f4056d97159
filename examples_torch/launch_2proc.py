"""Run ``examples_torch/pmc_large_scale.py`` as two ``torch.distributed``
ranks and check that both computed the identical adapted mixture: the
port's counterpart of ``examples/launch_2proc.py`` (the reference's
``mpirun -n 2 examples/pmc_mpi.py``).

    python examples_torch/launch_2proc.py --particles 100000 --steps 3

Each rank is a process of its own, joined by ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``; both run on ``--device``
(default: the card, which the two ranks share) over ``--backend`` (default
gloo: NCCL refuses two ranks on one card).  Any other arguments go to the
example.  Exits 0 iff both ranks succeed and print the same ``adapted
digest`` line (every rank applies the same all-reduced statistics; no rank
broadcasts a proposal).
"""

import argparse
import os
import socket
import subprocess
import sys

import pypmc_tpu_torch as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples_torch", "pmc_large_scale.py")
TIMEOUT = 900   # seconds a rank may take


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    args, forward = ap.parse_known_args(argv)
    with pt.using_device(args.device):
        pt.default_device()   # raises here, not in the ranks, where the device is absent

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base_env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    WORLD_SIZE="2")
    base_env["PYTHONPATH"] = REPO + os.pathsep + base_env.get("PYTHONPATH", "")
    command = [sys.executable, EXAMPLE, "--device", args.device, "--backend",
               args.backend] + forward
    procs = [subprocess.Popen(command, env=dict(base_env, RANK=str(rank)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outputs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            out += "\n(killed at the %d s limit)" % TIMEOUT
        outputs.append(out)
    for p in procs:
        p.wait()

    ok = True
    digests = []
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            print("process %d FAILED (rc=%s):\n%s" % (rank, p.returncode, out[-3000:]))
            ok = False
            continue
        line = [l for l in out.splitlines() if l.startswith("adapted digest:")]
        if not line:
            print("process %d printed no digest:\n%s" % (rank, out[-2000:]))
            ok = False
        else:
            digests.append(line[0])
        if rank == 0:
            sys.stdout.write(out)
    if ok and len(set(digests)) != 1:
        print("DIGEST MISMATCH across processes: %s" % digests)
        ok = False
    print("2-process run: %s" % ("OK (identical adapted mixture on both processes)"
                                 if ok else "FAILED"))
    return {"ok": ok, "digests": digests, "returncodes": [p.returncode for p in procs],
            "outputs": outputs}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
