"""A chain's steps in chunks, replayed as CUDA graphs on the card.

The JAX package runs a chain's steps as one jitted ``lax.scan``
(``pypmc_tpu/sampler/markov_chain.py:33-70``, compiled once per target and
run length) and the tensor pool's cycle as another (``:386-419``).  The
port's counterpart is :class:`Scan`: it runs a step function over a run's
inputs, all drawn before the run, in chunks of at most :data:`CHUNK` steps
through buffers of fixed address.  On a CUDA device the first chunk runs
eagerly on a side stream (the warm-up ``torch.cuda.graphs`` asks for);
after it, each chunk length is captured once as a ``torch.cuda.CUDAGraph``
and replayed, with the chunk's inputs copied in before a replay and its
outputs copied out after.  A replay runs the eager loop's kernels on the
same inputs in the same order, so it gives the same results bit for bit.
Elsewhere the chunks run eagerly through the same buffers.

A step that cannot be captured -- a target that returns a Python number or
a tensor off the device, calls ``.item()`` or copies to the host -- fails
the capture; the scan logs one warning naming the cause, counts it, and
runs its chunks eagerly from then on, on the same device.  Any other error
propagates.  While a graph is captured the kernel wrappers count their
launches once, and nothing runs: the scan takes those counts back and adds
them again on every replay (:func:`pypmc_tpu_torch.ops.kernels.add_launch_counts`),
so the launch counts report what ran.
"""

import logging

import torch

from ..ops import kernels as _k

logger = logging.getLogger(__name__)

__all__ = ["CHUNK", "Scan", "Uncapturable", "check_capturable", "counts", "reset_counts"]

# steps a graph, timed on the card (chip_smoke.py --chunk-sweep: the three
# chain examples at their published sizes, 8 to 125 steps a graph, two
# timed passes): r_group.py, whose five chains each capture their own
# graph, ran 41-50 us a step at 8 and 16 steps alike and 52-65 us at 32 to
# 125 (a capture costs about an eager run of its steps); markov_chain.py
# 30-33 us at every length.  16 takes half the replays of 8.
CHUNK = 16

# "replays": chunks replayed as graphs; "captures": graphs captured;
# "warm-ups": first chunks run eagerly before a capture; "uncapturable":
# scans whose step could not be captured; "fallbacks": chunks those ran
# eagerly on a CUDA device
counts = {}


def reset_counts():
    """Set every count of :data:`counts` to 0."""
    counts.update({"replays": 0, "captures": 0, "warm-ups": 0, "uncapturable": 0,
                   "fallbacks": 0})


reset_counts()


class Uncapturable(RuntimeError):
    """A step, run while a graph is captured, that no replay could repeat."""


def check_capturable(value, like):
    """Raise :class:`Uncapturable` unless a target's ``value`` is a tensor on
    the device of ``like``: a Python number or a host tensor would be baked
    into the graph, or copied to the device with a synchronization."""
    if not isinstance(value, torch.Tensor) or value.device != like.device:
        where = value.device if isinstance(value, torch.Tensor) else type(value).__name__
        raise Uncapturable("the target returned %s, not a tensor on %s" % (where, like.device))


def _capture_cause(err):
    """The first line of the capture error in ``err``'s chain, or None for
    an error that is not one: a step that cannot be replayed, or what CUDA
    and PyTorch raise for work a stream capture may not record (a
    synchronization, a host copy, an invalidated capture)."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if isinstance(err, Uncapturable) or "captur" in str(err).lower():
            return (str(err).strip().splitlines() or [type(err).__name__])[0]
        err = err.__cause__ or err.__context__
    return None


def _launches_since(before):
    after = _k.launch_counts()
    return {name: n - before.get(name, 0) for name, n in after.items()}


class _Card:
    """The CUDA side of a :class:`Scan`: which devices it serves, the
    warm-up, the capture and the replay (the CPU tests put a stand-in in
    its place)."""

    @staticmethod
    def serves(device):
        return device.type == "cuda"

    @staticmethod
    def warm_up(device, steps):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.device(device), torch.cuda.stream(side):
            steps()
        torch.cuda.current_stream(device).wait_stream(side)

    @staticmethod
    def capture(device, steps):
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(device)
        try:
            with torch.cuda.device(device), torch.cuda.graph(graph):
                steps()
        except RuntimeError:
            # a capture that fails ends without restoring the stream
            torch.cuda.set_stream(stream)
            torch.cuda.synchronize(device)
            raise
        return graph

    @staticmethod
    def replay(graph):
        graph.replay()


class Scan:
    """Runs ``body`` over the steps of a run in chunks of at most
    :data:`CHUNK` steps (its value when the scan is made), through buffers
    of fixed address, as CUDA graphs on the card.

    ``body(xs, ys, carry, consts, strict)`` runs ``len(xs[0])`` steps: it
    reads the step inputs ``xs`` (tensors, the steps first), writes the
    step outputs ``ys`` (likewise), and updates the ``carry`` tensors in
    place at its end; ``consts`` are inputs every step shares.  With
    ``strict`` (a graph is being captured) it calls
    :func:`check_capturable` on its target's values.  One scan serves one
    body at one set of shapes but the steps, one dtype and one device; it
    keeps its graphs, one a chunk length, for later runs."""

    _card = _Card

    def __init__(self, body):
        self.body = body
        self.chunk = CHUNK
        self.uncapturable = None     # the cause, once a capture failed
        self._buffers = None         # (xs, ys, carry, consts) of fixed address
        self._graphs = {}            # steps -> (graph, launches of one replay)
        self._warm = False

    def run(self, xs, ys, carry, consts=()):
        """Run the steps of ``xs`` (writing ``ys``) from the state ``carry``;
        return the carry after the last step (new tensors)."""
        if self._buffers is None:
            def chunked(t):
                return torch.empty((self.chunk,) + tuple(t.shape[1:]), dtype=t.dtype,
                                   device=t.device)
            self._buffers = (tuple(map(chunked, xs)), tuple(map(chunked, ys)),
                             tuple(map(torch.empty_like, carry)),
                             tuple(map(torch.empty_like, consts)))
        bx, by, bc, bk = self._buffers
        pairs = [(b, t, 1) for b, t in zip(bx + by, tuple(xs) + tuple(ys))]
        pairs += [(b, t, 0) for b, t in zip(bc + bk, tuple(carry) + tuple(consts))]
        for b, t, first in pairs:
            if b.shape[first:] != t.shape[first:] or b.dtype != t.dtype or b.device != t.device:
                raise ValueError("a scan runs one set of shapes: %s %s on %s, got %s %s on %s"
                                 % (tuple(b.shape), b.dtype, b.device, tuple(t.shape),
                                    t.dtype, t.device))
        for b, t in zip(bc + bk, tuple(carry) + tuple(consts)):
            b.copy_(t)
        n = xs[0].shape[0]
        for s0 in range(0, n, self.chunk):
            m = min(self.chunk, n - s0)
            for b, x in zip(bx, xs):
                b[:m].copy_(x[s0:s0 + m])
            self._steps(m)
            for b, y in zip(by, ys):
                y[s0:s0 + m].copy_(b[:m])
        return tuple(b.clone() for b in bc)

    def _body(self, m, strict=False):
        bx, by, bc, bk = self._buffers
        self.body(tuple(b[:m] for b in bx), tuple(b[:m] for b in by), bc, bk, strict)

    def _steps(self, m):
        """The next ``m`` steps: a replay, or the eager body."""
        device = self._buffers[2][0].device
        if not self._card.serves(device):
            self._body(m)
        elif not self._warm:
            self._card.warm_up(device, lambda: self._body(m))
            self._warm = True
            counts["warm-ups"] += 1
        elif self.uncapturable is None and (m in self._graphs or self._capture(m, device)):
            graph, launches = self._graphs[m]
            self._card.replay(graph)
            _k.add_launch_counts(launches)
            counts["replays"] += 1
        else:
            counts["fallbacks"] += 1
            self._body(m)

    def _capture(self, m, device):
        """Capture the ``m``-step graph; False, with the cause logged, where
        the body cannot be captured."""
        before = _k.launch_counts()
        try:
            graph = self._card.capture(device, lambda: self._body(m, strict=True))
        except RuntimeError as err:
            _k.add_launch_counts(_launches_since(before), -1)
            cause = _capture_cause(err)
            if cause is None:
                raise
            self.uncapturable = cause
            counts["uncapturable"] += 1
            logger.warning("%r cannot be captured as a CUDA graph (%s): its steps run "
                           "eagerly, one launch at a time", self.body, cause)
            return False
        launches = _launches_since(before)
        _k.add_launch_counts(launches, -1)    # the capture ran nothing
        self._graphs[m] = (graph, launches)
        counts["captures"] += 1
        return True
