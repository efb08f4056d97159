"""Run-segmented sample storage.

API parity with the reference's ``pypmc/tools/_history.py``: an append-only
store of 1d arrays where each :meth:`History.append` opens a new "run" whose
memory is handed back to the caller as a writable view.
"""

import numpy as _np

__all__ = ["History"]


class History(object):
    """Save a history of 1d-arrays; each call to :meth:`append` counts as a
    new "run".  ``self[i]`` returns the samples of run ``i`` (negative
    indices and slices supported; slicing merges runs into one array).

    :param dim: Integer; the length of the 1d-arrays to be saved.
    :param prealloc: Integer; number of points for which memory is allocated
        in advance (grown on demand).
    """

    def __init__(self, dim, prealloc=1):
        self.dim = int(dim)
        assert self.dim == dim, "dim must be an integer"
        self.prealloc = max(int(prealloc), 1)
        assert self.prealloc == max(prealloc, 1), "prealloc must be an integer"
        self.clear()

    def __getitem__(self, item):
        if not self._run_slices[item]:
            # keep the (0, dim) second axis: consumers index h[:][:, 0] /
            # vstack against it even before the first run
            return self._points[:0]
        if isinstance(item, slice):
            if item.step is not None:
                raise NotImplementedError("slices with a step are not supported")
            selected = self._run_slices[item]
            return self._points[selected[0][0] : selected[-1][1]]
        start, stop = self._run_slices[item]
        return self._points[start:stop]

    def __len__(self):
        return len(self._run_slices)

    def append(self, new_points_len):
        """Allocate memory for a new run and return a writable ``(n, dim)``
        view into it."""
        new_points_len = int(new_points_len)
        assert new_points_len >= 1, "append needs at least one point"

        start = self._run_slices[-1][1] if self._run_slices else 0
        stop = start + new_points_len
        self._run_slices.append((start, stop))

        if stop > len(self._points):
            # grow: at least double, at least enough
            new_capacity = max(2 * len(self._points), stop)
            grown = _np.empty((new_capacity, self.dim))
            grown[:start] = self._points[:start]
            self._points = grown

        return self._points[start:stop]

    def clear(self):
        """Drop all stored runs."""
        self._points = _np.empty((self.prealloc, self.dim))
        self._run_slices = []
