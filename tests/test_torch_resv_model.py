"""K4's design (``csrc/resv_scan.cu``) as a numpy model, held to the JAX
package's reservoir scan (``jaxresv.scan_budgets`` and
``scan_budgets_batched``) and to the port's plain version (the native
host scan behind ``ops/resv.py`` on a CPU tensor) on every budget and
every carried level.

The model schedules the work as the kernel does: a tile of
``resv.MAX_GRANULES_A_FRAME`` granules at a time (whole frames), first
every ``more_bits`` of the tile at once -- float64, pe*3.1 and the
subtraction rounded separately, x86-64's conversion of a value outside
the 64-bit range, held in [-1e9, 1e9] -- then one carry walked through
the tile in order with C division and remainder.  The kernel itself runs
only on the card, where tests/test_torch_resv_card.py and chip_smoke.py
hold it to the host scan; here the cases cover its arithmetic and its
schedule: tests/test_torch_resv.py's cases, 1, 3 and 16 clips with
distinct carried levels, padded holes in one row for every clip and in
a row each, ``resv_max == 0``, LSF (one granule a frame), an odd
``mean_bits`` in stereo, several tiles, and pe on the float32 knife
edge of trunc(pe*3.1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.ops import jaxresv
from mp3tpu_torch.ops import resv

torch.set_num_threads(1)

TILE = resv.MAX_GRANULES_A_FRAME


def _cdiv(a, b):
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _crem(a, b):
    return a - b * _cdiv(a, b)


def more_bits(pe, mean):
    """The kernel's parallel phase on a tile's pe (float32)."""
    m = pe.astype(np.float64) * 3.1
    m = m - np.float64(mean)
    inside = (m >= -2.0 ** 63) & (m < 2.0 ** 63)
    t = np.where(inside, np.trunc(np.where(inside, m, 0.0)), -2.0 ** 63)
    return np.clip(t, -1e9, 1e9).astype(np.int64)


def model(pe, demand, valid, size0, mean_bits, resv_max, mode_gr, nch,
          delta):
    """K4 on pe (B, F, R) float32, demand (B, F, R), valid None, (F,) or
    (B, F) bool, size0 (B,): (budgets (B, F, R), size_out (B,))."""
    B, F, R = pe.shape
    mean = _cdiv(mean_bits, nch)
    max_bits = min(mean, 4095)
    budgets = np.zeros((B, F, R), np.int64)
    sizes = np.zeros(B, np.int64)
    per_tile = TILE // R
    for b in range(B):
        size = int(size0[b])
        for f0 in range(0, F, per_tile):
            nf = min(per_tile, F - f0)
            more = more_bits(pe[b, f0:f0 + nf].reshape(-1), mean)
            dem = demand[b, f0:f0 + nf].reshape(-1).astype(np.int64)
            if valid is None:
                val = np.ones(nf, bool)
            else:
                val = (valid if valid.ndim == 1 else valid[b])[f0:f0 + nf]
            for f in range(nf):
                size_in = size
                for r in range(R):
                    i = f * R + r
                    if resv_max == 0:
                        bud = max_bits
                    else:
                        add = 0
                        if more[i] > 100:
                            add = min(_cdiv(size * 6, 10), int(more[i]))
                        over = size - _cdiv(resv_max * 8, 10) - add
                        if over > 0:
                            add += over
                        bud = min(max_bits + add, 4095)
                    budgets[b, f0 + f, r] = bud
                    used = int(dem[i]) if dem[i] < bud else bud - delta
                    size += mean - max(used, 0)
                if nch == 2 and mean_bits & 1:
                    size += 1
                size = min(size, resv_max)
                size -= _crem(size, 8)
                if not val[f]:
                    size = size_in
        sizes[b] = size
    return budgets, sizes


def _inputs(rng, B, F, R):
    pe = rng.uniform(0, 3000, (B, F, R)).astype(np.float32)
    pe[rng.rand(B, F, R) < 0.2] = 0.0
    demand = rng.randint(0, 4096, (B, F, R)).astype(np.int32)
    demand[rng.rand(B, F, R) < 0.05] = 0
    return pe, demand


def _jax_one(pe, demand, size0, args, valid=None):
    bud, size = jaxresv.scan_budgets(
        jnp.asarray(pe), jnp.asarray(demand), jnp.int32(size0), *args,
        valid=None if valid is None else jnp.asarray(valid))
    return np.asarray(bud, np.int64), int(size)


def _plain_one(pe, demand, size0, args, valid=None):
    bud, size = resv.scan_budgets(
        torch.as_tensor(pe), torch.as_tensor(demand), int(size0), *args,
        valid=None if valid is None else torch.as_tensor(valid))
    return bud.numpy().astype(np.int64), int(size)


#: seed, frames, nch, mode_gr, mean_bits, resv_max, delta, size0, valid:
#: tests/test_torch_resv.py's cases, more tiles, LSF, resv_max 0
ONE_CLIP = [
    (0, 200, 2, 2, 3080, 4088, 28, 0, "all"),
    (1, 150, 1, 2, 1460, 4088, 28, 512, "tail"),
    (2, 128, 2, 2, 3081, 4088, 12, 1024, "tail"),
    (3, 100, 2, 2, 3080, 4088, 0, 200, "holes"),
    (4, 60, 2, 2, 3080, 0, 28, 0, "tail"),
    (5, 1024, 2, 2, 3080, 4088, 28, 2000, "holes"),
    (6, 2500, 1, 1, 1080, 2040, 28, 96, "holes"),
    (7, 300, 2, 1, 1331, 2040, 28, 8, "tail"),
]


def _valid(kind, rng, F):
    if kind == "all":
        return np.ones(F, bool)
    if kind == "tail":
        return np.arange(F) < F - 23
    return rng.rand(F) < 0.8


@pytest.mark.parametrize("seed,F,nch,mode_gr,mean_bits,resv_max,delta,"
                         "size0,valid", ONE_CLIP,
                         ids=[f"case{c[0]}-{c[-1]}" for c in ONE_CLIP])
def test_model_equals_jax_and_the_host_scan(seed, F, nch, mode_gr,
                                            mean_bits, resv_max, delta,
                                            size0, valid):
    rng = np.random.RandomState(seed)
    R = mode_gr * nch
    pe, demand = _inputs(rng, 1, F, R)
    vf = _valid(valid, rng, F)
    args = (mean_bits, resv_max, mode_gr, nch, delta)
    got_b, got_s = model(pe, demand, vf, [size0], *args)
    want_b, want_s = _jax_one(pe[0], demand[0], size0, args, vf)
    np.testing.assert_array_equal(got_b[0], want_b)
    assert got_s[0] == want_s
    plain_b, plain_s = _plain_one(pe[0], demand[0], size0, args, vf)
    np.testing.assert_array_equal(got_b[0], plain_b)
    assert got_s[0] == plain_s


#: B, frames, nch, mode_gr, mean_bits, resv_max: the corpus's batches
BATCHED = [
    (1, 431, 2, 2, 3344, 4088),
    (3, 200, 2, 2, 3081, 4088),
    (16, 431, 2, 2, 3344, 4088),
    (3, 120, 1, 1, 1080, 2040),
    (3, 90, 2, 2, 3080, 0),
]


@pytest.mark.parametrize("B,F,nch,mode_gr,mean_bits,resv_max", BATCHED,
                         ids=[f"B{c[0]}-F{c[1]}-nch{c[2]}-gr{c[3]}-"
                              f"mb{c[4]}-max{c[5]}" for c in BATCHED])
def test_model_equals_the_batched_scans(B, F, nch, mode_gr, mean_bits,
                                        resv_max):
    """Clips with distinct carried levels, every frame real: the model
    == ``jaxresv.scan_budgets_batched`` == the port's plain batch."""
    rng = np.random.RandomState(B * 1000 + F)
    R = mode_gr * nch
    pe, demand = _inputs(rng, B, F, R)
    size0 = (rng.randint(0, max(resv_max, 8) + 1, B) // 8 * 8) \
        .astype(np.int32)
    size0[0] = 0
    args = (mean_bits, resv_max, mode_gr, nch, 28)
    got_b, got_s = model(pe, demand, None, size0, *args)
    want_b, want_s = jaxresv.scan_budgets_batched(
        jnp.asarray(pe), jnp.asarray(demand), jnp.asarray(size0), *args)
    np.testing.assert_array_equal(got_b, np.asarray(want_b, np.int64))
    np.testing.assert_array_equal(got_s, np.asarray(want_s, np.int64))
    plain_b, plain_s = resv.scan_budgets_batched(
        torch.as_tensor(pe), torch.as_tensor(demand),
        torch.as_tensor(size0), *args)
    np.testing.assert_array_equal(got_b, plain_b.numpy())
    np.testing.assert_array_equal(got_s, plain_s.numpy())


def test_model_with_a_valid_row_a_clip():
    """Three clips, each with its own padded holes and level: the model
    with (B, F) flags == each clip's JAX scan with its row."""
    rng = np.random.RandomState(21)
    B, F, nch, mode_gr = 3, 150, 2, 2
    pe, demand = _inputs(rng, B, F, nch * mode_gr)
    valid = rng.rand(B, F) < 0.75
    size0 = np.array([0, 800, 4000])
    args = (3081, 4088, mode_gr, nch, 28)
    got_b, got_s = model(pe, demand, valid, size0, *args)
    for b in range(B):
        want_b, want_s = _jax_one(pe[b], demand[b], size0[b], args, valid[b])
        np.testing.assert_array_equal(got_b[b], want_b)
        assert got_s[b] == want_s


def test_model_on_the_knife_edge():
    """pe whose trunc(pe*3.1 - mean) differs between float32 and float64
    arithmetic: the model (float64, as the kernel) == JAX's scan; the
    float32 form would not be."""
    rng = np.random.RandomState(5)
    mean = 3080 // 2
    cand = rng.uniform(600, 3000, 2000000).astype(np.float32)
    f32 = np.trunc(cand * np.float32(3.1) - np.float32(mean))
    f64 = np.trunc(cand.astype(np.float64) * 3.1 - mean)
    edge = cand[f32 != f64]
    assert len(edge) >= 40
    F = len(edge) // 4
    pe = edge[:4 * F].reshape(1, F, 4)
    demand = rng.randint(0, 4096, (1, F, 4)).astype(np.int32)
    args = (3080, 4088, 2, 2, 28)
    got_b, got_s = model(pe, demand, None, [512], *args)
    want_b, want_s = _jax_one(pe[0], demand[0], 512, args)
    np.testing.assert_array_equal(got_b[0], want_b)
    assert got_s[0] == want_s
    assert not np.array_equal(more_bits(pe, mean),
                              np.trunc(pe * np.float32(3.1)
                                       - np.float32(mean)))


def test_more_bits_outside_the_int64_range():
    """x86-64's conversion: a value at or past 2^63 (or NaN) becomes the
    most negative integer, so it adds nothing; the clamp keeps every
    comparison the recurrence makes."""
    pe = np.array([0.0, 100.0, 2.0e18, 1.0e30, np.nan, -1.0e30],
                  np.float32)
    got = more_bits(pe, 1540)
    assert got.tolist() == [-1540, -1230, int(1e9), -int(1e9), -int(1e9),
                            -int(1e9)]


def test_the_wrapper_refuses_what_k4_does_not_take():
    """The launch checks run before any library is loaded: a float64 pe,
    a demand of another shape, a valid row on another device."""
    pe = torch.zeros((1, 4, 4), dtype=torch.float64)
    dem = torch.zeros((1, 4, 4), dtype=torch.int32)
    size0 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        resv._check_k4(pe, dem, None, size0, 2, 2)
    with pytest.raises(ValueError):
        resv._check_k4(pe.float(), dem[:, :3], None, size0, 2, 2)
    with pytest.raises(ValueError):
        resv._check_k4(pe.float(), dem, None, size0, 1, 2)
    with pytest.raises(ValueError):
        resv._check_k4(pe.float(), dem, torch.ones(4, dtype=torch.bool,
                                                   device="meta"),
                       size0, 2, 2)
