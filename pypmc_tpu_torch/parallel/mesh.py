"""The particle mesh: the ranks that share the particle axis.

Counterpart of :mod:`pypmc_tpu.parallel.mesh`.  The problem's one
shardable axis is the particles; mixture parameters are replicated.  Where
the JAX package builds a ``jax.sharding.Mesh`` over all devices, the port's
mesh is the ranks of a ``torch.distributed`` group, one device each (two
ranks may share a card, as gloo allows; NCCL wants a card a rank).  The
JAX sharding objects (``particle_sharding``, ``replicated_sharding``) have
no counterpart: each rank holds its own shard of particles as an ordinary
tensor, and the sums over particles go through :meth:`ParticleMesh.reduce`.
"""

import torch

from .. import _device

__all__ = ["particle_mesh", "distributed_initialize", "PARTICLE_AXIS"]

PARTICLE_AXIS = "particles"


class ParticleMesh(object):
    """A 1-D mesh of ``size`` ranks over the particle axis: this process is
    ``rank``, its particles live on ``device``, and ``group`` is the
    ``torch.distributed`` group the statistics are summed over (None in one
    process outside an initialized group)."""

    def __init__(self, size, rank, group, device, axis_name=PARTICLE_AXIS):
        self.size = int(size)
        self.rank = int(rank)
        self.group = group
        self.device = torch.device(device)
        self.axis_names = (axis_name,)

    def __repr__(self):
        return "ParticleMesh(size=%d, rank=%d, device=%s, axis_names=%r)" % (
            self.size, self.rank, self.device, self.axis_names)

    def reduce(self, x):
        """The sum of ``x`` over the mesh's ranks (the JAX package's
        ``psum``): an ``all_reduce`` of a contiguous copy, in ``x``'s dtype;
        ``x`` itself in one process."""
        if self.group is None:
            return x
        out = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.SUM,
                                     group=self.group)
        return out

    def barrier(self):
        """Wait until every rank of the mesh arrives here."""
        if self.group is not None:
            torch.distributed.barrier(group=self.group)

    def all_gather(self, x):
        """Every rank's ``x`` concatenated along the first axis in rank
        order, as a host tensor: through the card with
        ``all_gather_into_tensor`` under NCCL, through host tensors under
        gloo (which gathers no CUDA tensor).  Every rank's ``x`` must have
        the same shape."""
        if self.group is None:
            return x.cpu()
        x = x.contiguous()
        if torch.distributed.get_backend(self.group) == "nccl":
            out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            torch.distributed.all_gather_into_tensor(out, x, group=self.group)
            return out.cpu()
        x = x.cpu()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        torch.distributed.all_gather(parts, x, group=self.group)
        return torch.cat(parts)


def checked(mesh):
    """``mesh`` if it is None or a :class:`ParticleMesh`; ``TypeError``
    for anything else (a JAX mesh, say)."""
    if mesh is not None and not isinstance(mesh, ParticleMesh):
        raise TypeError("mesh must be a particle mesh (pypmc_tpu_torch.parallel."
                        "particle_mesh()), got %r" % (mesh,))
    return mesh


def particle_mesh(devices=None, axis_name: str = PARTICLE_AXIS) -> ParticleMesh:
    """The 1-D particle mesh of this process: inside an initialized
    ``torch.distributed`` group, its world size, this rank and the group;
    outside one, one rank.  ``devices`` gives each rank's device (a
    sequence of one a rank, e.g. ``["cuda:0", "cuda:0"]`` for two ranks on
    one card) or this rank's (one device); default: the port's device
    (:func:`pypmc_tpu_torch.default_device`)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if devices is None:
        device = _device.default_device()
    elif isinstance(devices, (str, torch.device)):
        device = devices
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError("%d devices for a mesh of %d ranks" % (len(devices), size))
        device = devices[rank]
    return ParticleMesh(size, rank, group, device, axis_name)


def distributed_initialize(coordinator_address=None, num_processes=None,
                           process_id=None, **kwargs):
    """Join this process to a ``torch.distributed`` group (the reference's
    ``mpirun`` + mpi4py start-up): ``coordinator_address`` ``"host:port"``
    (None: the ``MASTER_ADDR``/``MASTER_PORT`` environment), the number of
    processes and this one's rank (None: ``WORLD_SIZE``/``RANK``).  The
    backend is ``kwargs["backend"]`` if given, else ``"nccl"`` where the
    port runs on the card and ``"gloo"`` on the CPU; further keywords go to
    ``torch.distributed.init_process_group``.  Then only rank 0 logs below
    ERROR (:func:`pypmc_tpu_torch.tools.log_to_stdout`)."""
    backend = kwargs.pop("backend", None)
    if backend is None:
        backend = "nccl" if _device.default_device().type == "cuda" else "gloo"
    torch.distributed.init_process_group(
        backend=backend,
        init_method=None if coordinator_address is None else "tcp://" + coordinator_address,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id),
        **kwargs)
    from ..tools.util import log_to_stdout

    log_to_stdout()
