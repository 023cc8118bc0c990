"""K4's design (``csrc/resv_scan.cu``) as a numpy model, held to the JAX
package's reservoir scan (``jaxresv.scan_budgets`` and
``scan_budgets_batched``) and to the port's plain version (the native
host scan behind ``ops/resv.py`` on a CPU tensor) on every budget and
every carried level.

The model schedules the work as the kernels do, with the chunk as a
parameter (by default ``resv.chunk_frames``'s): the map build walks
every chunk but the last from each of its S + 1 states at once (the
levels 8*s in [0, resv_max] and "still size0"; the first chunk from
size0 alone) and records the state each ends in; the composition
follows the chunk starts through the maps, walking a chunk itself where
a level lies off the domain; the re-walk walks each chunk from its start
and writes its budgets.  ``more_bits`` is the kernels' -- float64,
pe*3.1 and the subtraction rounded separately, x86-64's conversion of a
value outside the 64-bit range, held in [-1e9, 1e9] -- and the carry
uses C division and remainder.  The kernels run only on the card, where
tests/test_torch_resv_card.py and chip_smoke.py hold them to the host
scan; here the cases cover their arithmetic and their schedule:
tests/test_torch_resv.py's cases, 1, 3 and 16 clips with distinct
carried levels, padded holes in one row for every clip and in a row
each, holes across chunk boundaries, a leading padded run from a size0
off the domain, ``resv_max`` 0, 7 and 8 (one or two states), LSF (one
granule a frame), an odd ``mean_bits`` in stereo, chunks of 1, 2, 7, F
and F + 1 frames, pe on the float32 knife edge of trunc(pe*3.1), and a
negative size0 or delta (the composition's own walks).  A property test
holds the lemma the design rests on, and another the host's chunk
choice.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mp3tpu.ops import jaxresv
from mp3tpu_torch.ops import resv

torch.set_num_threads(1)

#: a map entry for a level off the domain that is not size0 (kUnknown)
UNKNOWN = -1


def _cdiv(a, b):
    """C's integer division (truncates toward zero), b > 0; also on
    arrays."""
    q = np.abs(a) // b
    return np.where(np.asarray(a) < 0, -q, q)


def more_bits(pe, mean):
    """The kernels' more_bits of pe (float32), as the map build stages
    it."""
    m = pe.astype(np.float64) * 3.1
    m = m - np.float64(mean)
    inside = (m >= -2.0 ** 63) & (m < 2.0 ** 63)
    t = np.where(inside, np.trunc(np.where(inside, m, 0.0)), -2.0 ** 63)
    return np.clip(t, -1e9, 1e9).astype(np.int64)


class Scan:
    """The constants of one scan (csrc/resv_scan.cu struct Scan)."""

    def __init__(self, mean_bits, resv_max, mode_gr, nch, delta):
        self.R = mode_gr * nch
        self.mean = int(_cdiv(mean_bits, nch))
        self.max_bits = min(self.mean, 4095)
        self.resv_max, self.delta = resv_max, delta
        self.cap = int(_cdiv(resv_max * 8, 10))
        self.odd = nch == 2 and mean_bits & 1
        self.S = max(resv_max, 0) // 8 + 1

    def state_of(self, size, size0):
        """8*s on the domain -> s, size0 -> S, else UNKNOWN; on arrays."""
        size = np.asarray(size, np.int64)
        on = (size >= 0) & (size <= self.resv_max) & (size % 8 == 0)
        return np.where(on, size // 8,
                        np.where(size == size0, self.S, UNKNOWN))


def walk(size, more, dem, val, p):
    """Frames of more_bits and demand (nf, R) and flags (nf,) walked from
    the levels `size` (n,) at once: (budgets (nf, R, n), levels (n,))."""
    size = np.array(size, np.int64)
    nf = more.shape[0]
    bud = np.zeros((nf, p.R, size.size), np.int64)
    for f in range(nf):
        size_in = size
        for r in range(p.R):
            if p.resv_max == 0:
                b = np.full(size.shape, p.max_bits, np.int64)
            else:
                add = np.zeros_like(size)
                if more[f, r] > 100:
                    add = np.minimum(_cdiv(size * 6, 10), more[f, r])
                over = size - p.cap - add
                add = add + np.maximum(over, 0)
                b = np.minimum(p.max_bits + add, 4095)
            bud[f, r] = b
            used = np.where(dem[f, r] < b, dem[f, r], b - p.delta)
            size = size + p.mean - np.maximum(used, 0)
        if p.odd:
            size = size + 1
        size = np.minimum(size, p.resv_max)
        size = size - (size - 8 * _cdiv(size, 8))
        if not val[f]:
            size = size_in
    return bud, size


def model(pe, demand, valid, size0, mean_bits, resv_max, mode_gr, nch,
          delta, chunk=None, walked=None):
    """K4 on pe (B, F, R) float32, demand (B, F, R), valid None, (F,) or
    (B, F) bool, size0 (B,), at `chunk` frames a chunk: (budgets
    (B, F, R), size_out (B,)).  The (clip, chunk) pairs the composition
    walks itself are appended to `walked`."""
    B, F, R = pe.shape
    p = Scan(mean_bits, resv_max, mode_gr, nch, delta)
    C = chunk or resv.chunk_frames(B, F, R, resv_max)
    K = max(1, -(-F // C))
    states = np.arange(p.S + 1)
    budgets = np.zeros((B, F, R), np.int64)
    sizes = np.zeros(B, np.int64)
    for b in range(B):
        more = more_bits(pe[b], p.mean)
        dem = demand[b].astype(np.int64)
        val = (np.ones(F, bool) if valid is None
               else (valid if valid.ndim == 1 else valid[b]).astype(bool))
        s0 = int(size0[b])

        def frames(k, more=more, dem=dem, val=val):
            c = slice(k * C, min(F, (k + 1) * C))
            return more[c], dem[c], val[c]

        # the map build: every chunk but the last, from each state
        maps = np.full((max(K - 1, 0), p.S + 1), UNKNOWN, np.int64)
        for k in range(K - 1):
            start = np.where(states == p.S, s0, 8 * states)
            live = states if k else states[-1:]
            _, end = walk(start[live], *frames(k), p)
            maps[k, live] = p.state_of(end, s0)
        # the composition: the chunk starts, one lookup a chunk
        starts, state, size = [], p.S, s0
        for k in range(K):
            starts.append(size)
            if k + 1 == K:
                break
            nxt = maps[k, state] if state != UNKNOWN else UNKNOWN
            if nxt != UNKNOWN:
                state, size = int(nxt), 8 * int(nxt) if nxt < p.S else s0
            else:
                size = int(walk([size], *frames(k), p)[1][0])
                if walked is not None:
                    walked.append((b, k))
                state = int(p.state_of(size, s0))
        # the re-walk: each chunk from its start
        for k in range(K):
            bud, end = walk([starts[k]], *frames(k), p)
            budgets[b, k * C:k * C + bud.shape[0]] = bud[:, :, 0]
        sizes[b] = end[0]
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
#: tests/test_torch_resv.py's cases, more tiles, LSF, resv_max 0; then a
#: leading padded run from a size0 off the domain (not a multiple of 8,
#: above resv_max; LSF; one frame; every frame padded), holes across the
#: chunk boundaries, resv_max 7 and 8
ONE_CLIP = [
    (0, 200, 2, 2, 3080, 4088, 28, 0, "all"),
    (1, 150, 1, 2, 1460, 4088, 28, 512, "tail"),
    (2, 128, 2, 2, 3081, 4088, 12, 1024, "tail"),
    (3, 100, 2, 2, 3080, 4088, 0, 200, "holes"),
    (4, 60, 2, 2, 3080, 0, 28, 0, "tail"),
    (5, 1024, 2, 2, 3080, 4088, 28, 2000, "holes"),
    (6, 2500, 1, 1, 1080, 2040, 28, 96, "holes"),
    (7, 300, 2, 1, 1331, 2040, 28, 8, "tail"),
    (8, 300, 2, 2, 3080, 4088, 28, 203, "lead"),
    (9, 300, 2, 2, 3344, 4088, 28, 5000, "lead"),
    (10, 400, 1, 1, 1080, 2040, 28, 203, "lead"),
    (11, 1, 2, 2, 3080, 4088, 28, 203, "lead"),
    (12, 100, 2, 2, 3080, 4088, 28, 5000, "none"),
    (13, 500, 2, 2, 3344, 4088, 28, 96, "straddle"),
    (14, 200, 2, 2, 3080, 7, 28, 0, "holes"),
    (15, 200, 2, 2, 3081, 8, 28, 8, "straddle"),
]


def _valid(kind, rng, F, C):
    """The frames' flags: all real, a padded tail, random holes, a
    leading padded run over several chunks, every frame padded, or holes
    of 1-3 frames across chunk boundaries (chunks of C frames)."""
    if kind == "all":
        return np.ones(F, bool)
    if kind == "tail":
        return np.arange(F) < F - 23
    if kind == "lead":
        return np.arange(F) >= min(F, 3 * C + C // 2 + 1)
    if kind == "none":
        return np.zeros(F, bool)
    if kind == "straddle":
        v = rng.rand(F) < 0.9
        for edge in range(C, F, C):
            lo = edge - rng.randint(0, 3)
            v[max(lo, 0):edge + rng.randint(1, 3)] = False
        return v
    return rng.rand(F) < 0.8


def _one_clip(seed, F, nch, mode_gr, mean_bits, resv_max, valid):
    rng = np.random.RandomState(seed)
    R = mode_gr * nch
    pe, demand = _inputs(rng, 1, F, R)
    C = resv.chunk_frames(1, F, R, resv_max)
    return pe, demand, _valid(valid, rng, F, C)


@pytest.mark.parametrize("seed,F,nch,mode_gr,mean_bits,resv_max,delta,"
                         "size0,valid", ONE_CLIP,
                         ids=[f"case{c[0]}-{c[-1]}" for c in ONE_CLIP])
def test_model_equals_jax_and_the_host_scan(seed, F, nch, mode_gr,
                                            mean_bits, resv_max, delta,
                                            size0, valid):
    pe, demand, vf = _one_clip(seed, F, nch, mode_gr, mean_bits, resv_max,
                               valid)
    args = (mean_bits, resv_max, mode_gr, nch, delta)
    walked = []
    got_b, got_s = model(pe, demand, vf, [size0], *args, walked=walked)
    assert walked == []         # every level on the domain or size0
    want_b, want_s = _jax_one(pe[0], demand[0], size0, args, vf)
    np.testing.assert_array_equal(got_b[0], want_b)
    assert got_s[0] == want_s
    plain_b, plain_s = _plain_one(pe[0], demand[0], size0, args, vf)
    np.testing.assert_array_equal(got_b[0], plain_b)
    assert got_s[0] == plain_s


#: seed of ONE_CLIP, then the chunk: 1, 2, 7, F and F + 1 frames
CHUNKED = [(c, chunk) for c in (0, 3, 6, 8, 12, 13, 14)
           for chunk in (1, 2, 7, "F", "F+1")]


@pytest.mark.parametrize("case,chunk", CHUNKED,
                         ids=[f"case{c}-C{k}" for c, k in CHUNKED])
def test_model_at_forced_chunks(case, chunk):
    """Every chunk gives the host scan's budgets and level; the holes of
    "straddle" cross the forced chunk's boundaries."""
    seed, F, nch, mode_gr, mean_bits, resv_max, delta, size0, valid = \
        ONE_CLIP[case]
    C = {"F": F, "F+1": F + 1}.get(chunk, chunk)
    rng = np.random.RandomState(seed)
    pe, demand = _inputs(rng, 1, F, mode_gr * nch)
    vf = _valid(valid, rng, F, C)
    args = (mean_bits, resv_max, mode_gr, nch, delta)
    got_b, got_s = model(pe, demand, vf, [size0], *args, chunk=C)
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


@pytest.mark.parametrize("nch,mode_gr,mean_bits,resv_max", [
    (2, 2, 3344, 4088), (1, 1, 1080, 2040)], ids=["mpeg1", "lsf"])
def test_model_with_a_valid_row_a_clip_off_the_domain(nch, mode_gr,
                                                      mean_bits, resv_max):
    """Four clips, each its own leading padded run or holes across the
    chunk boundaries, levels off the domain among them: MPEG-1 (S + 1 =
    513 states) and LSF (257)."""
    rng = np.random.RandomState(31)
    B, F = 4, 240
    pe, demand = _inputs(rng, B, F, nch * mode_gr)
    C = resv.chunk_frames(B, F, nch * mode_gr, resv_max)
    valid = np.stack([_valid(k, rng, F, C) for k in
                      ("lead", "straddle", "lead", "holes")])
    size0 = np.array([203, 0, 5000, 96])
    args = (mean_bits, resv_max, mode_gr, nch, 28)
    got_b, got_s = model(pe, demand, valid, size0, *args)
    for b in range(B):
        want_b, want_s = _jax_one(pe[b], demand[b], size0[b], args, valid[b])
        np.testing.assert_array_equal(got_b[b], want_b)
        assert got_s[b] == want_s
        plain_b, plain_s = _plain_one(pe[b], demand[b], size0[b], args,
                                      valid[b])
        np.testing.assert_array_equal(got_b[b], plain_b)
        assert got_s[b] == plain_s


@pytest.mark.parametrize("size0,delta,chunk", [
    (-100000, 28, None), (-100000, 28, 3), (96, -40, None),
    (96, -40, 1)],
    ids=["size0-neg", "size0-neg-C3", "delta-neg", "delta-neg-C1"])
def test_model_off_the_domain_walks_the_chunk(size0, delta, chunk):
    """A negative size0 or delta takes the level off the domain after a
    real frame (no path passes either); the composition then walks the
    chunk itself, and the model still == the host scan.  (JAX's scan
    floor-divides, so it differs from C on a negative level.)"""
    rng = np.random.RandomState(41)
    F = 120
    pe, demand = _inputs(rng, 1, F, 4)
    vf = rng.rand(F) < 0.85
    args = (3080, 4088, 2, 2, delta)
    walked = []
    got_b, got_s = model(pe, demand, vf, [size0], *args, chunk=chunk,
                         walked=walked)
    assert walked
    plain_b, plain_s = _plain_one(pe[0], demand[0], size0, args, vf)
    np.testing.assert_array_equal(got_b[0], plain_b)
    assert got_s[0] == plain_s


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


@settings(max_examples=150, deadline=None, database=None)
@given(nch=st.sampled_from([1, 2]), mode_gr=st.sampled_from([1, 2]),
       mean_bits=st.integers(0, 6000), resv_max=st.integers(0, 4095),
       delta=st.integers(0, 60), size0=st.integers(0, 100000),
       seed=st.integers(0, 2 ** 31 - 1), F=st.integers(1, 12))
def test_every_frame_end_level_lies_on_the_domain(nch, mode_gr, mean_bits,
                                                  resv_max, delta, size0,
                                                  seed, F):
    """The lemma: from any size0 >= 0, the host scan's level after every
    frame is a multiple of 8 in [0, resv_max] -- so S = resv_max/8 + 1
    states, and "still size0", are all a map needs."""
    rng = np.random.RandomState(seed)
    R = mode_gr * nch
    pe = np.where(rng.rand(F, R) < 0.3, 0.0,
                  rng.exponential(3000.0, (F, R)))
    demand = rng.randint(0, 8000, (F, R)).astype(np.int64)
    size = size0
    for f in range(F):
        _, size = resv._native(pe[f:f + 1], demand[f:f + 1], size,
                               mean_bits, resv_max, mode_gr, nch, delta)
        assert 0 <= size <= resv_max and size % 8 == 0, (f, size)


#: B, F, R, resv_max: the main path's segments (4096 and 512 lanes), a
#: corpus group of 16, LSF, long clips, one frame, no frame, resv_max 0,
#: a map too wide for one block
CHOICES = [(1, 1024, 4, 4088), (1, 128, 4, 4088), (16, 431, 4, 4088),
           (32, 431, 4, 4088), (1, 2500, 1, 2040), (1, 200000, 4, 4088),
           (1, 10 ** 6, 1, 2040), (4, 1, 4, 4088), (1, 0, 4, 4088),
           (3, 90, 4, 0), (1, 300, 4, 10 ** 5)]


@pytest.mark.parametrize("B,F,R,resv_max", CHOICES,
                         ids=[f"B{c[0]}-F{c[1]}-R{c[2]}-max{c[3]}"
                              for c in CHOICES])
def test_the_chunk_choice(B, F, R, resv_max):
    """The host's chunk: the K chunks fit the walk block's threads and
    their K - 1 maps its shared memory (a map wider than MAX_STATES
    states: one chunk); the map build's blocks, its chunks' states split
    by state_groups, fill the SMs wherever the states allow; the
    composition's lookups stay within the walks' granules."""
    C = resv.chunk_frames(B, F, R, resv_max)
    K = max(1, -(-F // C))
    S1 = resv.states(resv_max)
    assert 1 <= C <= max(F, 1)
    assert K <= resv.MAX_CHUNKS
    words = resv.map_words(F, C, resv_max)
    assert words % 8 == 0 and 2 * words <= resv.MAP_SMEM_BYTES
    if S1 > resv.MAX_STATES:
        assert K == 1
    if K == 1:
        assert words == 0
        return
    assert words >= (K - 1) * S1
    # the map build's launch (csrc/resv_scan.cu launch)
    G = resv.state_groups(B, F, C, resv_max)
    threads = -(-(-(-S1 // G)) // 32) * 32
    blocks = B * (K - 1) * -(-S1 // threads)
    assert 32 <= threads <= resv.MAX_STATES
    assert blocks >= min(resv.SMS, B * (K - 1) * -(-S1 // 32))
    if C == math.ceil(math.sqrt(F / (3 * R) * math.sqrt(B))):
        assert K - 1 <= 3 * C * R


def test_the_chunk_choice_takes_one_frame_and_past_the_end():
    """F = 1 is one chunk; a forced chunk past F is one chunk too, with
    no map; the model agrees with the host scan at both."""
    rng = np.random.RandomState(51)
    for F, C in ((1, None), (1, 5), (9, 10), (9, 9)):
        pe, demand = _inputs(rng, 2, F, 4)
        size0 = np.array([0, 4000])
        assert resv.map_words(F, C or resv.chunk_frames(2, F, 4, 4088),
                              4088) == 0
        args = (3344, 4088, 2, 2, 28)
        got_b, got_s = model(pe, demand, None, size0, *args, chunk=C)
        plain_b, plain_s = resv.scan_budgets_batched(
            torch.as_tensor(pe), torch.as_tensor(demand),
            torch.as_tensor(size0), *args)
        np.testing.assert_array_equal(got_b, plain_b.numpy())
        np.testing.assert_array_equal(got_s, plain_s.numpy())


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
