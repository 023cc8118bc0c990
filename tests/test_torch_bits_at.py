"""bits_at, one bit evaluation of the rate loop: its plain chain against
the eager chain it replaces and against the JAX package's count_all,
exactly, and the wrapper's input checks.  The CUDA kernel against the
plain chain on the card is in tests/test_torch_bits_at_card.py."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.ops import jaxloop
from mp3tpu.tables import mpeg
from mp3tpu_torch.ops import bits_at as K
from mp3tpu_torch.ops import loop
from mp3tpu_torch.ops.hist_c1 import hist_c1_plain
from test_torch_bits_at_card import kernel_args, random_batch

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

VERSIONS = [(mpeg.MPEG1, 0), (mpeg.MPEG1, 1), (mpeg.MPEG2_LSF, 0)]


def _chain(xr75p, qss, is_short, is_short_block, ST):
    """The rate loop's evaluation as it was written before bits_at."""
    ixp = loop.quantize_pow75(xr75p, qss)
    c = loop.count_all(ixp, is_short, is_short_block, ST, pre_permuted=True)
    bits = torch.where(c["ix_max"] <= loop.IXMAX, c["bits"], 1e9)
    return bits, c


def _args(batch, version, sf):
    ST = loop.device_tables(loop.static_tables(version, sf), "cpu")
    return tuple(torch.tensor(a) for a in batch) + (ST,)


@pytest.mark.parametrize("seed,G", [(0, 64), (1, 64), (2, 97)])
@pytest.mark.parametrize("version,sf", VERSIONS)
def test_plain_equals_eager_chain(seed, G, version, sf):
    args = _args(random_batch(seed, G), version, sf)
    got = K.bits_at_plain(*args)
    bits, want = _chain(*args)
    assert torch.equal(got.pop("bits"), bits)
    want.pop("bits")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert 0 < int((bits == 1e9).sum()) < G


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("version,sf", VERSIONS)
def test_plain_counts_equal_jax_count_all(seed, version, sf):
    """The same quantized ixp through jaxloop.count_all(pre_permuted=True):
    every count equal, and the bits wherever ix_max <= IXMAX."""
    xr75, qss, is_short, wsf = batch = random_batch(10 + seed, 48)
    got = K.bits_at_plain(*_args(batch, version, sf))
    ixp = loop.quantize_pow75(torch.tensor(xr75), torch.tensor(qss)).numpy()
    ref = jaxloop.count_all(jnp.asarray(ixp), jnp.asarray(is_short),
                            jnp.asarray(wsf), jaxloop._static(version, sf),
                            pre_permuted=True)
    for k in ("count1", "big_values", "r0", "r1", "a1", "a2", "table_select",
              "count1table_select", "ix_max"):
        np.testing.assert_array_equal(np.asarray(ref[k], np.int64),
                                      got[k].numpy().astype(np.int64), k)
    in_range = np.asarray(ref["ix_max"]) <= loop.IXMAX
    np.testing.assert_array_equal(np.asarray(ref["bits"])[in_range],
                                  got["bits"].numpy()[in_range])
    assert np.all(got["bits"].numpy()[~in_range] == 1e9)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    args = kernel_args(*random_batch(5, 40), "cpu")
    before = K.bits_at.launches
    got = K.bits_at(*args)
    bits, c = loop._bits_at(*args)
    assert K.bits_at.launches == before == 0
    assert bits is c["bits"]
    want = K.bits_at_plain(*args)
    for k in want:
        assert torch.equal(got[k], want[k]) and torch.equal(c[k], want[k])


def test_count_all_takes_the_histogram_it_is_given(monkeypatch):
    calls = []

    def hist(*a):
        calls.append(a[0].shape)
        return hist_c1_plain(*a)

    monkeypatch.setattr(K, "hist_c1_plain", hist)
    K.bits_at_plain(*kernel_args(*random_batch(6, 24), "cpu"))
    assert calls == [(24, 576)]


@pytest.mark.parametrize("case", ["dtype", "shape", "device",
                                  "contiguous", "flags", "unsupported"])
def test_wrapper_refuses_bad_inputs_before_any_launch(case):
    xr75p, qss, short, wsf, ST = kernel_args(*random_batch(1, 16), "cpu")
    before = K.bits_at.launches
    if case == "dtype":
        err, args = TypeError, (xr75p.double(), qss, short, wsf)
    elif case == "shape":
        err, args = ValueError, (xr75p[:, :575].contiguous(), qss, short,
                                 wsf)
    elif case == "device":
        err, args = ValueError, (xr75p, qss.to("meta"), short, wsf)
    elif case == "contiguous":
        err, args = ValueError, (xr75p.t().contiguous().t(), qss, short, wsf)
    elif case == "flags":
        err, args = TypeError, (xr75p, qss, short.to(torch.int32), wsf)
    else:
        err, args = ValueError, tuple(t.to("meta")
                                      for t in (xr75p, qss, short, wsf))
    with pytest.raises(err):
        K.bits_at(*args, ST)
    assert K.bits_at.launches == before


def test_table_pack_and_rows_match_the_cuda_source():
    """The kernel's constants (read from csrc/bits_at.cu) against the
    Python side: the per-rate pack's offsets and the output rows."""
    with open(K.SOURCE) as f:
        src = f.read()
    const = {m.group(1): m.group(2) for m in
             re.finditer(r"constexpr int (k\w+) = ([^;]+);", src)}
    sfb_l = loop.static_tables(mpeg.MPEG1, 1)["sfb_l"]
    pack = K.rate_tables(sfb_l)
    n_esc = int(const["kEsc"])
    assert const["kSfbL"] == "0" and const["kSubdv"] == "kSfbL + 23"
    assert const["kFirst"] == "kSubdv + 46"
    assert const["kEscA"] == "kFirst + 15" and const["kEscB"] == "kEscA + kEsc"
    assert pack.shape == (84 + 2 * n_esc,) == (K.RATE_INTS,)
    np.testing.assert_array_equal(pack[:23], sfb_l[:23])
    np.testing.assert_array_equal(pack[23:69], mpeg.SUBDV_TABLE.reshape(-1))
    # ESC table A's last entry (past every linmax) and B's first
    assert pack[84 + n_esc - 1] == 0 and pack[84 + n_esc] == 24
    assert int(const["kOut"]) == len(K.ROWS)
    cases = dict(re.findall(r"case (\d+): v = (?:__float_as_int\()?(\w+)",
                            src))
    names = {"count1": "count1", "big_values": "big_values", "r0": "r0",
             "r1": "r1", "a1": "a1", "a2": "a2", "ts0": "table_select",
             "ts1": "table_select", "ts2": "table_select",
             "c1_sel": "count1table_select", "bits": "bits"}
    for i, row in enumerate(K.ROWS[:-1]):
        assert names[cases[str(i)]] == row, (i, row)
    assert K.ROWS[-1] == "ix_max" and "default: v = ix_max" in src
    assert os.path.basename(K.LIBRARY) == "libbits_at.so"
