"""K1, the bit-count histogram: the port's plain version against the JAX
package's XLA formulation and its Pallas kernel (interpret mode), bit
for bit.  The CUDA kernel against the plain version on the card is in
tests/test_torch_hist_c1_card.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.ops import jaxloop, pallas_bits
from mp3tpu.tables import mpeg
from mp3tpu_torch.ops import hist_c1 as k1
from test_torch_hist_c1_card import random_batch

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)


def _jax_inputs(ix, is_short, wsf):
    ST = jaxloop._static(mpeg.MPEG1, 0)
    ixj, short = jnp.asarray(ix), jnp.asarray(is_short)
    count1, big_values = jaxloop.calc_runlen(ixj, short)
    r0, r1, a1, a2 = jaxloop.subdivide(big_values, short, jnp.asarray(wsf),
                                       ST)
    return ST, ixj, short, count1, big_values, a1, a2


def _plain(ix, a1, a2, big_values, count1, is_short, r0_pairs_short):
    t = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    return k1.hist_c1_plain(
        t(ix), t(a1), t(a2), t(big_values), t(count1),
        torch.from_numpy(np.asarray(is_short, bool)), r0_pairs_short)


def _as_np(out):
    return [np.asarray(o.cpu().numpy(), np.int64) for o in out]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_interpret(seed):
    ix, is_short, wsf = random_batch(seed, 32)
    ST, ixj, short, count1, big_values, a1, a2 = _jax_inputs(ix, is_short,
                                                             wsf)
    ref = pallas_bits.hist_c1(ixj, a1, a2, big_values, count1, short, ST,
                              tg=8, interpret=True)
    got = _plain(ix, a1, a2, big_values, count1, is_short,
                 ST["r0_pairs_short"])
    for r, g in zip(ref, _as_np(got)):
        np.testing.assert_array_equal(np.asarray(r, np.int64), g)


@pytest.mark.parametrize("seed,G", [(0, 32), (1, 32), (2, 32), (0, 37)])
def test_plain_matches_xla(seed, G):
    ix, is_short, wsf = random_batch(seed, G)
    ST, ixj, short, count1, big_values, a1, a2 = _jax_inputs(ix, is_short,
                                                             wsf)
    bt_ref, mx_ref = jaxloop._region_table_bits(
        ixj, a1, a2, 2 * big_values, short, ST["r0_pairs_short"])
    c1_ref, sel_ref = jaxloop._count1_bits(ixj, big_values, count1)
    bt, mx, b0raw, signs = _as_np(_plain(ix, a1, a2, big_values, count1,
                                         is_short, ST["r0_pairs_short"]))
    np.testing.assert_array_equal(np.asarray(bt_ref, np.int64), bt)
    np.testing.assert_array_equal(np.asarray(mx_ref, np.int64), mx)
    b0 = b0raw + signs
    b1 = 4 * np.asarray(count1, np.int64) + signs
    sel = np.where(b0 < b1, 0, 1)
    np.testing.assert_array_equal(np.asarray(sel_ref), sel)
    np.testing.assert_array_equal(np.asarray(c1_ref, np.int64),
                                  np.where(sel == 0, b0, b1))


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    ix, is_short, wsf = random_batch(3, 16)
    ST, ixj, short, count1, big_values, a1, a2 = _jax_inputs(ix, is_short,
                                                             wsf)
    t = lambda a: torch.tensor(np.asarray(a, np.int32))  # noqa: E731
    before = k1.hist_c1.launches
    got = k1.hist_c1(t(ix), t(a1), t(a2), t(big_values), t(count1),
                     torch.from_numpy(is_short), ST["r0_pairs_short"])
    assert k1.hist_c1.launches == before == 0
    assert got[0].dtype == torch.float32
    want = _plain(ix, a1, a2, big_values, count1, is_short,
                  ST["r0_pairs_short"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
