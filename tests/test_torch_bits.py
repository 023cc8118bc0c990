"""Main-data emission and packing: mp3tpu_torch.ops.bits against
mp3tpu.ops.jaxbits, exactly, given the same coding state and signed ix
(from the JAX rate loop on the batch of tests/test_jaxbits.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp3tpu.ops import jaxbits, jaxloop
from mp3tpu.tables import mpeg
from mp3tpu_torch.ops import bits, loop

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(7)
    G = 24
    xr = rng.randn(G, 576).astype(np.float32) * 40
    xr[::3, 200:] = 0
    xr[1] *= 400            # big linbits values
    xr[2] = 0               # silent granule
    xr[4, 100:] = 0
    bt = np.full(G, mpeg.NORM_TYPE, np.int32)
    bt[5:9] = 2
    bt[9] = 1
    bt[10] = 3
    is_short_block = bt != mpeg.NORM_TYPE
    ST = jaxloop._static(mpeg.MPEG1, 0)
    budget = np.full(G, 1200.0, np.float32)
    budget[6] = 4095.0
    budget[7] = 300.0
    out = jaxloop.outer_loop(jnp.asarray(xr), jnp.asarray(budget),
                             jnp.zeros((G, 21), jnp.float32) + 0.02,
                             jnp.zeros((G, 12, 3), jnp.float32) + 0.02,
                             jnp.asarray(is_short_block), jnp.asarray(bt),
                             ST)
    out = {k: np.asarray(v) for k, v in out.items()}
    ix_signed = np.where((xr < 0) & (out["ix"] > 0), -out["ix"], out["ix"])
    is_short = is_short_block & (bt == 2)
    # scfsi-style skipped bands on a few long granules
    skip = np.zeros((G, 21), bool)
    skip[[0, 3, 11], :6] = True
    return out, ix_signed.astype(np.int32), is_short, skip, ST


def _tables(ST):
    return (loop.device_tables(loop.static_tables(mpeg.MPEG1, 0), "cpu"),
            bits.device_tables("cpu"))


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


def test_elements_match_jax(batch):
    state, ix_signed, is_short, skip, ST = batch
    STt, BT = _tables(ST)
    st_j = {k: jnp.asarray(v) for k, v in state.items()}
    st_t = {k: torch.tensor(v) for k, v in state.items()}
    for sk in (None, skip):
        vj, lj = jaxbits.granule_elements(
            st_j, jnp.asarray(ix_signed), jnp.asarray(is_short), ST,
            skip_mask=None if sk is None else jnp.asarray(sk))
        vt, lt = bits.granule_elements(
            st_t, torch.tensor(ix_signed), torch.tensor(is_short), STt, BT,
            skip_mask=None if sk is None else torch.tensor(sk))
        lj = np.asarray(lj, np.int64)
        np.testing.assert_array_equal(lj, lt.numpy())
        # values only matter under their length
        mask = (1 << lj) - 1
        np.testing.assert_array_equal(_u32(vj) & mask,
                                      vt.numpy() & mask)


def test_payload_words_nbits_and_compaction_match_jax(batch):
    state, ix_signed, is_short, skip, ST = batch
    STt, BT = _tables(ST)
    st_j = {k: jnp.asarray(v) for k, v in state.items()}
    st_t = {k: torch.tensor(v) for k, v in state.items()}
    for pw in (bits.PAYLOAD_WORDS, 24):     # 24 words truncates some rows
        wj, nj = jaxbits.granule_payload(
            st_j, jnp.asarray(ix_signed), jnp.asarray(is_short), ST, pw,
            skip_mask=jnp.asarray(skip))
        wt, nt = bits.granule_payload(
            st_t, torch.tensor(ix_signed), torch.tensor(is_short), STt, BT,
            pw, skip_mask=torch.tensor(skip))
        np.testing.assert_array_equal(np.asarray(nj, np.int64), nt.numpy())
        np.testing.assert_array_equal(_u32(wj), wt.numpy())
        np.testing.assert_array_equal(np.asarray(wj),
                                      bits.to_uint32(wt))
        cap = bits.payload_cap_words(12, 3344, 256, 4088, 24)
        assert cap == jaxbits.payload_cap_words(12, 3344, 256, 4088, 24)
        fj = jaxbits.compact_payload(wj, nj, cap)
        ft = bits.compact_payload(wt, nt, cap)
        np.testing.assert_array_equal(_u32(fj), ft.numpy())


def test_nbits_equals_part2_3_length(batch):
    state, ix_signed, is_short, skip, ST = batch
    STt, BT = _tables(ST)
    st_t = {k: torch.tensor(v) for k, v in state.items()}
    _, nbits = bits.granule_payload(st_t, torch.tensor(ix_signed),
                                    torch.tensor(is_short), STt, BT)
    np.testing.assert_array_equal(nbits.numpy(), state["part2_3_length"])


def test_pack_elements_random():
    rng = np.random.RandomState(3)
    G, E = 8, 100
    lengths = rng.randint(0, 33, size=(G, E)).astype(np.int32)
    lengths[:, ::7] = 0
    values = rng.randint(0, 2 ** 32, size=(G, E), dtype=np.uint64) \
        .astype(np.uint32)
    wj, nj = jaxbits.pack_elements_jit(jnp.asarray(values),
                                       jnp.asarray(lengths), 128)
    wt, nt = bits.pack_elements(torch.tensor(values.astype(np.int64)),
                                torch.tensor(lengths), 128)
    np.testing.assert_array_equal(np.asarray(nj, np.int64), nt.numpy())
    np.testing.assert_array_equal(np.asarray(wj), bits.to_uint32(wt))
