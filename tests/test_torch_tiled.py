"""fused_transform's tiled pair past D = 64, on the CPU: the mirror of its
bucket kernel (``_build.transform_tiles``: the permutation of the particles
by component and the slots of tiles the tiled kernel walks) and a tensor
walk over those tiles, which is what the tiled kernel computes, against
``plain_transform`` and against the JAX package's ``fused_transform`` (its
Pallas kernel in interpret mode).  Inputs are made with numpy and handed to
both packages.  The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py -k tiled``, ``chip_smoke.py``), where
their perm and slots are held to this mirror bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pypmc_tpu.density.core as jcore
import pypmc_tpu.ops.pallas_kernels as pk
import pypmc_tpu_torch
from pypmc_tpu_torch.density import core
from pypmc_tpu_torch.ops import _build, kernels

torch.set_num_threads(1)

CHUNK = _build.transform_bucket_plan(1)[1]   # particles a bucket block sorts


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


def latents(rng, K, N, empty=()):
    """N components drawn uniformly from [0, K), none from ``empty``."""
    live = np.array([k for k in range(K) if k not in empty])
    return live[rng.integers(0, live.shape[0], N)].astype(np.int32)


def walk_transform(zT, latent, scale, mu, L):
    """The tiled kernel's function: for each slot of ``transform_tiles``, its
    component k's particles ``cols`` get ``mu_k + (L_k z_cols) * scale_cols``
    (NaN where no tile writes)."""
    perm, slots = _build.transform_tiles(latent.numpy(), mu.shape[0])
    xT = torch.full_like(zT, float("nan"))
    for k, first, n, _ in slots[slots[:, 0] >= 0]:
        cols = torch.as_tensor(perm[first:first + n]).long()
        xT[:, cols] = mu[k][:, None] + (L[k] @ zT[:, cols]) * scale[cols]
    return xT


@pytest.mark.parametrize("K,N,empty", [
    (1, 1, ()), (1, 127, ()), (1, 128, ()), (3, 4099, ()), (60, 1, ()), (60, 127, ()),
    (60, 128, (0, 59)), (60, 4099, (0, 7, 59)), (5, 4099, (1, 2, 3)),
    (7, CHUNK + 129, (3,)), (60, 2 * CHUNK + 1, (30,)),
])
def test_every_particle_lands_in_one_tile_of_its_own_component(K, N, empty):
    """transform_tiles (the bucket kernel's mirror): perm lists each chunk's
    particles by component, each component's in their order; each slot is a
    tile of at most 128 of one component's particles within its chunk, the
    tiles of a chunk in its first slots, the components ascending; every
    particle is in exactly one tile, of its own component; an empty
    component has no tile; the slots are transform_slots(N, K) and the
    scratch holds perm and them."""
    rng = np.random.default_rng(K * 1000 + N)
    lat = latents(rng, K, N, empty)
    perm, slots = _build.transform_tiles(lat, K)
    n_slots = _build.transform_slots(N, K)
    assert slots.shape == (n_slots, 4) and perm.shape == (N,)
    assert _build.transform_scratch_words(N, K) == -(-N // 4) * 4 + 4 * n_slots
    per_chunk = CHUNK // 128 + K
    chunks = -(-N // CHUNK)
    assert n_slots == (chunks - 1) * per_chunk + -(-(N - (chunks - 1) * CHUNK) // 128) + K
    seen = np.zeros(N, np.int64)
    tiles = {}
    for s, (k, first, n, pad) in enumerate(slots):
        c = min(s // per_chunk, chunks - 1)
        if k < 0:
            assert (first, n, pad) == (0, 0, 0)
            continue
        assert 1 <= n <= 128 and pad == 0
        assert c * CHUNK <= first and first + n <= min(N, (c + 1) * CHUNK)
        cols = perm[first:first + n]
        assert (lat[cols] == k).all()
        assert (np.diff(cols) > 0).all()
        seen[cols] += 1
        tiles.setdefault(c, []).append((s, k, first))
    assert (seen == 1).all()
    assert not any((lat == k).any() for k in empty)
    for c, ts in tiles.items():
        # a chunk's tiles come first in its slots, component by component
        assert [s for s, _, _ in ts] == list(range(c * per_chunk, c * per_chunk + len(ts)))
        assert [k for _, k, _ in ts] == sorted(k for _, k, _ in ts)
        assert not set(k for _, k, _ in ts) & set(empty)
    # perm is the stable sort of each chunk by component
    for c0 in range(0, N, CHUNK):
        part = lat[c0:c0 + CHUNK]
        assert (perm[c0:c0 + part.shape[0]] == c0 + np.argsort(part, kind="stable")).all()


def test_a_latent_outside_the_components_is_left_out():
    """A latent outside [0, K) is in no tile (the kernel writes no column
    for it); the others are bucketed as before."""
    lat = np.array([0, 3, 1, -1, 1, 2, 0], np.int32)
    perm, slots = _build.transform_tiles(lat, 3)
    live = slots[slots[:, 0] >= 0]
    assert [tuple(t) for t in live] == [(0, 0, 2, 0), (1, 2, 2, 0), (2, 4, 1, 0)]
    assert perm[:5].tolist() == [0, 6, 2, 4, 5] and (perm[5:] == -1).all()


def _mixture(rng, K, D, dtype):
    means = rng.normal(0, 2, (K, D))
    a = rng.normal(0, 0.4, (K, D, D))
    covs = np.eye(D)[None] + np.einsum("kij,klj->kil", a, a)
    w = rng.uniform(0.5, 1.5, K)
    jp, valid = jcore.make_mixture(means.astype(dtype), covs.astype(dtype),
                                   (w / w.sum()).astype(dtype))
    assert bool(np.asarray(valid).all())
    return jp, core.params_from_numpy(jp)


@pytest.mark.parametrize("K,D,N", [(1, 65, 300), (4, 65, 1000), (3, 130, 700), (60, 66, 4099)])
def test_walk_over_the_tiles_is_the_plain_transform(K, D, N):
    """The walk over transform_tiles' slots (the tiled kernel's function)
    equals plain_transform in float64, a dead component's bucket empty, to
    1e-12 (the two group the same products in other matrix shapes)."""
    rng = np.random.default_rng(K + D + N)
    _, tp = _mixture(rng, K, D, np.float64)
    ops = core._kernel_operands(tp)
    zT = torch.tensor(rng.normal(size=(D, N)))
    lat = torch.tensor(latents(rng, K, N, (K // 2,) if K > 2 else ()))
    scale = torch.tensor(rng.uniform(0.5, 1.5, N))
    got = walk_transform(zT, lat, scale, tp.means, tp.chol)
    ref = kernels.plain_transform(zT, lat, scale, ops)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    # the wrapper on the CPU takes its plain version for every variant
    for variant in kernels._transform_variants(D):
        torch.testing.assert_close(kernels.fused_transform(zT, lat, scale, ops, variant=variant),
                                   ref, rtol=0, atol=0)


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(pk, "INTERPRET", True)


@pytest.mark.parametrize("K,D,N", [(1, 65, 257), (3, 65, 400), (2, 130, 300)])
def test_walk_over_the_tiles_matches_pallas_interpret(interpret, K, D, N):
    """The walk over the tiles on float32 numpy inputs against the JAX
    package's fused_transform (its Pallas kernel in interpret mode, as
    tests/test_pallas_kernels.py runs it).  The Pallas kernel contracts in
    split precision, its error ~2^-16 of the intermediate |L z|, so the
    bound is that test's: rtol 1e-4, atol 5e-4."""
    rng = np.random.default_rng(10 * K + D)
    jp, tp = _mixture(rng, K, D, np.float32)
    z = rng.normal(size=(D, N)).astype(np.float32)
    lat = latents(rng, K, N)
    scale = rng.uniform(0.5, 1.5, N).astype(np.float32)
    ref = pk.fused_transform(jnp.asarray(z), jnp.asarray(lat), jnp.asarray(scale),
                             jp.chol.reshape(K * D, D), jp.means.T, dim=D)
    got = walk_transform(torch.tensor(z), torch.tensor(lat), torch.tensor(scale), tp.means,
                         tp.chol)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("D", [65, 96, 128, 129, 200, 2040])
def test_the_tiled_pair_is_elected_past_d64(D):
    """From TRANSFORM_TILED_D_MIN the plan is the tiled pair (its product
    kernel's 256 threads and 41,600 B, a tile of 128 particles a block); the
    looped kernel stays forcible to D = 128, the record kernel to 64; the
    bucket kernel's shared memory is within a block's for every K the JAX
    rule admits past D = 64 (60 at D = 65) and past it limit_reason names
    it."""
    assert _build.TRANSFORM_TILED_D_MIN == 65
    assert _build.transform_plan(19, D) == ("tiled", False, 0, 256, _build.tiled_plan()[4])
    assert kernels._elect("fused_transform", 19, D, None) == "tiled"
    assert kernels._transform_variants(D) == (("looped", "tiled") if D <= 128 else ("tiled",))
    assert _build.block_particles("fused_transform", D) == 128
    assert _build.transform_bucket_plan(60)[3] <= _build.SMEM_LIMIT
    assert _build.limit_reason("fused_transform", 60, D) is None
    most = max(K for K in range(1, 4000) if _build.transform_bucket_plan(K)[3] <= _build.SMEM_LIMIT)
    assert "bucket" in _build.limit_reason("fused_transform", most + 1, D)
    assert _build.limit_reason("fused_transform", most + 1, 64) is None   # the record kernel
