"""fused_transform's tiled pair past D = 64, on the CPU: the mirror of the
bucket pass (``_build.transform_tiles``: each particle's position in the
order of the particles sorted by component, the permutation back, and the
slots of tiles the tiled kernel walks), of the moves of z into that order
and of x out of it (``_build.transform_permute``), and a tensor walk over
those tiles, which is what the pair computes, against ``plain_transform``
and against the JAX package's ``fused_transform`` (its Pallas kernel in
interpret mode).  Inputs are made with numpy and handed to both packages.
The kernels themselves run only on the card
(``tests/test_torch_kernels_gpu.py -k tiled``, ``chip_smoke.py``), where
their pos, perm and slots are held to this mirror bit for bit."""

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

SPAN = 1 << 15   # particles: 64 of the bucket pass's runs at this size


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
    """The tiled pair's function, walked as it runs: at K = 1 tiles of 128
    particles in order; else z and the scales moved into bucket order
    (``transform_permute``), for each slot of ``transform_tiles`` its
    component k's positions ``first .. first + n - 1`` get ``mu_k + (L_k
    zb) * scale_b``, and x moved out of bucket order (NaN where no tile
    writes)."""
    K = mu.shape[0]
    N = latent.shape[0]
    if K == 1:
        xT = torch.empty_like(zT)
        for t in range(0, N, 128):
            xT[:, t:t + 128] = mu[0][:, None] + (L[0] @ zT[:, t:t + 128]) * scale[t:t + 128]
        return xT
    _, slots, pos = _build.transform_tiles(latent.numpy(), K)
    width = _build.transform_width(N, K)
    zb = torch.as_tensor(_build.transform_permute(zT.numpy(), pos, width))
    sb = torch.as_tensor(_build.transform_permute(scale.numpy()[None], pos, width)[0])
    xb = torch.full_like(zb, float("nan"))
    for k, first, n, _ in slots[slots[:, 0] >= 0]:
        at = slice(first, first + n)
        xb[:, at] = mu[k][:, None] + (L[k] @ zb[:, at]) * sb[at]
    return torch.as_tensor(_build.transform_permute(xb.numpy(), pos, width, inverse=True))


def check_layout(lat, K):
    """transform_tiles' perm, slots and pos for the components ``lat``, of
    the sizes the bucket pass writes; returns them."""
    N = lat.shape[0]
    perm, slots, pos = _build.transform_tiles(lat, K)
    width = _build.transform_width(N, K)
    n_slots = _build.transform_slots(N, K)
    assert slots.shape == (n_slots, 4) and perm.shape == (width,) and pos.shape == (N,)
    assert n_slots == -(-N // 128) + K and width == -(-N // 4) * 4 + 4 * K
    return perm, slots, pos


@pytest.mark.parametrize("K,N,empty", [
    (1, 1, ()), (1, 127, ()), (1, 128, ()), (3, 4099, ()), (60, 1, ()), (60, 127, ()),
    (60, 128, (0, 59)), (60, 4099, (0, 7, 59)), (5, 4099, (1, 2, 3)),
    (7, SPAN + 129, (3,)), (60, 2 * SPAN + 1, (30,)),
])
def test_every_particle_lands_in_one_tile_of_its_own_component(K, N, empty):
    """transform_tiles (the bucket pass's mirror): the slots are the tiles
    of the buckets over all N, a tile at most 128 of one component's
    consecutive positions, the tiles in the first slots, the components
    ascending, each bucket from a multiple of 4 positions; every particle is
    in exactly one tile, of its own component; an empty component has no
    tile; perm is the stable sort of all N by component; the scratch's parts
    (the slots, perm, pos, the counts' table) each start at a multiple of 4
    words and hold their sizes."""
    rng = np.random.default_rng(K * 1000 + N)
    lat = latents(rng, K, N, empty)
    perm, slots, pos = check_layout(lat, K)
    seen = np.zeros(N, np.int64)
    live = slots[slots[:, 0] >= 0]
    assert (slots[len(live):] == (-1, 0, 0, 0)).all()
    assert live[:, 0].tolist() == sorted(live[:, 0].tolist())
    for k, first, n, pad in live:
        assert 1 <= n <= 128 and pad == 0 and first % 4 == 0
        cols = perm[first:first + n]
        assert (lat[cols] == k).all()
        assert (np.diff(cols) > 0).all()
        seen[cols] += 1
    assert (seen == 1).all()
    assert not set(live[:, 0].tolist()) & set(empty)
    assert (perm[perm >= 0] == np.argsort(lat, kind="stable")).all()
    at_perm, at_pos, table, words, pair, width, blocks = _build.transform_layout(N, K, 65)
    assert at_perm == 4 * len(slots) and at_pos == at_perm + width
    assert table == at_pos + -(-N // 4) * 4 and words == table + -(-blocks * K // 4) * 4
    assert all(w % 4 == 0 for w in (at_perm, at_pos, table, words, width))
    assert _build.transform_scratch_words(N, K, 65) == pair
    assert pair == words + 66 * width + 2 * (-(-N // 4) * 4)
    run = -(-N // blocks)
    assert blocks <= 512 and run <= max(512, -(-N // (512 * 256)) * 256)
    assert blocks == -(-N // max(512, -(-N // (512 * 256)) * 256))


@pytest.mark.parametrize("K,N,empty", [(3, 4099, ()), (60, 4099, (0, 7, 59)),
                                       (19, 2 * SPAN + 1, (4,)), (1, 300, ())])
def test_pos_is_the_inverse_of_perm(K, N, empty):
    """pos[n] is particle n's position and perm[pos[n]] = n; the positions
    no particle holds (each bucket's pad to 4, the tail past the last
    bucket) hold -1 in perm."""
    rng = np.random.default_rng(K + N)
    lat = latents(rng, K, N, empty)
    perm, _, pos = check_layout(lat, K)
    assert (pos >= 0).all() and pos.max() < perm.shape[0]
    assert (perm[pos] == np.arange(N)).all()
    held = perm >= 0
    assert held.sum() == N and (pos[perm[held]] == np.flatnonzero(held)).all()


@pytest.mark.parametrize("K,N", [(4, 4099), (60, SPAN + 129)])
def test_the_sort_is_stable_within_a_component(K, N):
    """Each component's particles hold consecutive positions from a
    multiple of 4, in the order of their indices: one input gives one
    layout."""
    rng = np.random.default_rng(7 * K + N)
    lat = latents(rng, K, N)
    _, _, pos = check_layout(lat, K)
    counts = np.bincount(lat, minlength=K)
    start = np.concatenate([[0], np.cumsum(-(-counts // 4) * 4)])[:-1]
    for k in range(K):
        members = np.flatnonzero(lat == k)
        assert (pos[members] == start[k] + np.arange(members.shape[0])).all()


def test_at_most_k_partial_tiles_over_a_whole_launch():
    """With the buckets over all N particles, a launch has at most one
    partial tile a component: at K = 60 and N = 2 x 32,768 + 1, at most 60
    tiles of fewer than 128 particles, and the slots that hold a tile are
    ceil(n_k / 128) summed over the components."""
    K, N = 60, 2 * SPAN + 1
    lat = latents(np.random.default_rng(60), K, N, (30,))
    _, slots, _ = check_layout(lat, K)
    live = slots[slots[:, 0] >= 0]
    partial = live[live[:, 2] < 128]
    assert len(partial) <= K and len(set(partial[:, 0].tolist())) == len(partial)
    counts = np.bincount(lat, minlength=K)
    assert len(live) == int((-(-counts // 128)).sum()) <= -(-N // 128) + K


@pytest.mark.parametrize("K,N,D", [(3, 4099, 5), (60, 4099, 17), (7, SPAN + 129, 3)])
def test_the_moves_are_a_permutation_walked_in_tiles(K, N, D):
    """transform_permute, walked as bucket_permute_kernel walks it (tiles of
    2,048 particles in bucket order, 4 rows a block): into bucket order,
    column pos[n] of the result is column n of its input and a position no
    particle holds is untouched (NaN); out of bucket order, the round trip
    gives the input back bit for bit; a particle whose latent is outside [0,
    K) is not moved either way."""
    rng = np.random.default_rng(K * D + N)
    lat = latents(rng, K, N)
    lat[::97] = K        # left out
    perm, _, pos = check_layout(lat, K)
    width = _build.transform_width(N, K)
    z = rng.normal(size=(D, N)).astype(np.float32)
    zb = _build.transform_permute(z, pos, width)
    held = pos >= 0
    assert np.array_equal(zb[:, pos[held]], z[:, held])
    assert np.isnan(zb[:, perm < 0]).all()
    back = _build.transform_permute(zb, pos, width, inverse=True)
    assert np.array_equal(back[:, held], z[:, held]) and np.isnan(back[:, ~held]).all()


def test_a_latent_outside_the_components_is_left_out():
    """A latent outside [0, K) is in no tile and has no position (the
    kernel writes no column for it); the others are bucketed as before,
    each bucket from a multiple of 4 positions."""
    lat = np.array([0, 3, 1, -1, 1, 2, 0], np.int32)
    perm, slots, pos = _build.transform_tiles(lat, 3)
    live = slots[slots[:, 0] >= 0]
    assert [tuple(t) for t in live] == [(0, 0, 2, 0), (1, 4, 2, 0), (2, 8, 1, 0)]
    assert perm[:9].tolist() == [0, 6, -1, -1, 2, 4, -1, -1, 5] and (perm[9:] == -1).all()
    assert pos.tolist() == [0, -1, 4, -1, 5, 8, 1]


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
    bucket pass's shared memory is within a block's for every K the JAX
    rule admits past D = 64 (60 at D = 65) and past it limit_reason names
    it."""
    assert _build.TRANSFORM_TILED_D_MIN == 65
    assert _build.transform_plan(19, D) == ("tiled", False, 0, 256, _build.tiled_plan()[4])
    assert kernels._elect("fused_transform", 19, D, None) == "tiled"
    assert kernels._transform_variants(D) == (("looped", "tiled") if D <= 128 else ("tiled",))
    assert _build.block_particles("fused_transform", D) == 128
    assert _build.transform_bucket_plan(60)[3] <= _build.SMEM_LIMIT
    assert _build.limit_reason("fused_transform", 60, D) is None
    most = max(K for K in range(1, 1 << 13)
               if _build.transform_bucket_plan(K)[3] <= _build.SMEM_LIMIT)
    assert "bucket" in _build.limit_reason("fused_transform", most + 1, D)
    assert _build.limit_reason("fused_transform", most + 1, 64) is None   # the record kernel
