"""Rate loop: mp3tpu_torch.ops.loop against mp3tpu.ops.jaxloop on the CPU.

Counting is integer work and must match exactly.  The outer loop runs on
the same float32 spectrum in both; |xr|^0.75 and 2^(-s/4) round
differently in the two libraries and can flip one nint, which moves a
granule onto another search path, so the loop is held to identical
integer outputs on at least 95% of granules (mismatches are printed).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.ops import jaxdsp, jaxloop, jaxpsy
from mp3tpu.tables import mpeg
from mp3tpu_torch.ops import loop
from test_torch_hist_c1_card import random_batch

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

INT_KEYS = ("ix", "part2_3_length", "global_gain", "big_values", "count1",
            "table_select", "count1table_select", "r0", "r1", "a1", "a2",
            "part2", "compress", "sf_l", "sf_s", "preflag")


@pytest.fixture(scope="module")
def tables():
    return jaxloop._static(mpeg.MPEG1, 0), loop.device_tables(
        loop.static_tables(mpeg.MPEG1, 0), "cpu")


def test_static_tables_equal_jax():
    for version in (mpeg.MPEG1, mpeg.MPEG2_LSF):
        for sf in (0, 1, 2):
            ref = jaxloop._static(version, sf)
            got = loop.static_tables(version, sf)
            assert ref.keys() == got.keys()
            for k in ref:
                np.testing.assert_array_equal(np.asarray(ref[k]),
                                              np.asarray(got[k]), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_runlen_subdivide_exact(tables, seed):
    STj, STt = tables
    ix, is_short, wsf = random_batch(seed, 48)
    c1_j, bv_j = jaxloop.calc_runlen(jnp.asarray(ix), jnp.asarray(is_short))
    sub_j = jaxloop.subdivide(bv_j, jnp.asarray(is_short), jnp.asarray(wsf),
                              STj)
    c1_t, bv_t = loop.calc_runlen(torch.tensor(ix), torch.tensor(is_short))
    sub_t = loop.subdivide(bv_t, torch.tensor(is_short), torch.tensor(wsf),
                           STt)
    for a, b in zip((c1_j, bv_j) + tuple(sub_j), (c1_t, bv_t) + sub_t):
        np.testing.assert_array_equal(np.asarray(a, np.int64),
                                      b.numpy().astype(np.int64))


def test_quantizers_match_jax():
    """Same float32 inputs: identical ix except where |xr|^0.75 or the
    step rounds to the other side of a .5 boundary in one library."""
    rng = np.random.RandomState(5)
    xr_abs = np.abs(rng.randn(64, 576) * 0.05).astype(np.float32)
    qss = rng.uniform(-80, 10, 64).astype(np.float32).round()
    xr75 = np.power(xr_abs, np.float32(0.75))
    for fj, ft, x in ((jaxloop.quantize, loop.quantize, xr_abs),
                      (jaxloop.quantize_pow75, loop.quantize_pow75, xr75)):
        a = np.asarray(fj(jnp.asarray(x), jnp.asarray(qss)), np.int64)
        b = ft(torch.tensor(x), torch.tensor(qss)).numpy().astype(np.int64)
        assert np.abs(a - b).max() <= 1
        assert (a == b).mean() >= 0.999, (a != b).sum()


@pytest.mark.parametrize("pre_permuted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_count_all_exact(tables, seed, pre_permuted):
    STj, STt = tables
    ix, is_short, wsf = random_batch(seed, 40)
    # the range check sends over-range lanes to 1e9 bits either way;
    # keep a few in range of every table
    ix = np.minimum(ix, 9000).astype(np.int32)
    ref = jaxloop.count_all(jnp.asarray(ix), jnp.asarray(is_short),
                            jnp.asarray(wsf), STj, pre_permuted=pre_permuted)
    got = loop.count_all(torch.tensor(ix), torch.tensor(is_short),
                         torch.tensor(wsf), STt, pre_permuted=pre_permuted)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ref[k], np.int64),
                                      got[k].numpy().astype(np.int64),
                                      err_msg=k)


def _graft_example():
    """__graft_entry__.entry()'s G=16 forward inputs, analysed by JAX."""
    rng = np.random.RandomState(0)
    blocks = (rng.randn(16, 576) * 3000).astype(np.float32)
    halo = np.zeros((2, 576), np.float32)
    psy = jaxpsy.psycho_granules(jnp.asarray(blocks), jnp.asarray(halo),
                                 44100.0)
    scaled = jnp.asarray(blocks) / 32768.0
    hs = jnp.asarray(halo) / 32768.0
    sb = jaxdsp.subband_granules(scaled, hs[1, 64:])
    sb_prev = jaxdsp.subband_granules(hs[1][None], hs[0, 64:])[0]
    xr = jaxdsp.mdct_granules(sb, sb_prev, psy["block_type"])
    return dict(xr=np.asarray(xr, np.float32),
                ratio_l=np.asarray(psy["ratio_l"], np.float32),
                ratio_s=np.asarray(psy["ratio_s"], np.float32),
                block_type=np.asarray(psy["block_type"], np.int32),
                budget=np.full(16, 900.0, np.float32))


def _mixed_blocks_example():
    """Short, start and stop blocks, silence, ESC values, mixed budgets."""
    rng = np.random.RandomState(7)
    G = 24
    xr = (rng.randn(G, 576) * 0.02).astype(np.float32)
    xr[::3, 200:] = 0
    xr[1] *= 40             # large values
    xr[2] = 0               # silent granule
    xr[4, 100:] = 0
    bt = np.zeros(G, np.int32)
    bt[5:9] = 2
    bt[9] = 1
    bt[10] = 3
    budget = np.full(G, 1200.0, np.float32)
    budget[6] = 4095.0
    budget[7] = 300.0
    budget[12:16] = 500.0
    return dict(xr=xr, ratio_l=np.full((G, 21), 0.02, np.float32),
                ratio_s=np.full((G, 12, 3), 0.02, np.float32),
                block_type=bt, budget=budget)


def _match_share(ref, got, G):
    differ = {}
    for k in INT_KEYS:
        a = np.asarray(ref[k], np.int64).reshape(G, -1)
        b = got[k].numpy().astype(np.int64).reshape(G, -1)
        differ[k] = ~(a == b).all(axis=1)
    bad = np.any(list(differ.values()), axis=0)
    for g in np.where(bad)[0]:
        print(f"granule {g}: differs in",
              [k for k in INT_KEYS if differ[k][g]],
              "p23 jax/torch", int(np.asarray(ref["part2_3_length"])[g]),
              int(got["part2_3_length"][g]))
    return 1.0 - bad.mean()


@pytest.mark.parametrize("example", [_graft_example, _mixed_blocks_example],
                         ids=["graft_entry_g16", "short_start_stop"])
def test_outer_loop_matches_jax(tables, example):
    STj, STt = tables
    d = example()
    bt = d["block_type"]
    ref = jaxloop.outer_loop(jnp.asarray(d["xr"]), jnp.asarray(d["budget"]),
                             jnp.asarray(d["ratio_l"]),
                             jnp.asarray(d["ratio_s"]),
                             jnp.asarray(bt != mpeg.NORM_TYPE),
                             jnp.asarray(bt), STj)
    got = loop.outer_loop(torch.tensor(d["xr"]), torch.tensor(d["budget"]),
                          torch.tensor(d["ratio_l"]),
                          torch.tensor(d["ratio_s"]),
                          torch.tensor(bt != mpeg.NORM_TYPE),
                          torch.tensor(bt), STt)
    G = len(bt)
    share = _match_share(ref, got, G)
    assert share >= 0.95, share
    assert (got["part2_3_length"].numpy() <= d["budget"]).all()
