"""Encoder configuration.

Mirrors the reference CLI surface (musicin.c:136-296 parse_args) in a
typed dataclass: layer 1/2/3, mode, psy model, bitrate, sample rate,
emphasis/copyright/original flags, CRC error protection.
"""
from dataclasses import dataclass, field

import numpy as np

from .tables import mpeg


@dataclass
class EncoderConfig:
    layer: int = 3
    mode: int = mpeg.MODE_STEREO           # header mode field
    psy_model: int = 2
    bitrate_kbps: int = 0                  # 0 -> per-layer default index 9
    sample_rate_hz: float = 44100.0
    emphasis: int = 0                      # 0 none, 1 50/15us, 3 CCITT J.17
    error_protection: bool = False
    copyright: bool = False
    original: bool = False
    extension: int = 0
    private_bits: int = 0

    # derived at finalize()
    version: int = field(default=mpeg.MPEG1, init=False)
    sampling_frequency: int = field(default=0, init=False)
    bitrate_index: int = field(default=0, init=False)
    nchannels: int = field(default=2, init=False)
    mode_ext: int = 0

    def finalize(self):
        sf_khz = self.sample_rate_hz / 1000.0
        self.version = None
        for v in (mpeg.MPEG1, mpeg.MPEG2_LSF):
            for j in range(3):
                if abs(mpeg.S_FREQ_KHZ[v][j] - sf_khz) < 1e-9:
                    self.version = v
                    self.sampling_frequency = j
        if self.version is None:
            raise ValueError(f"unsupported sample rate {self.sample_rate_hz}")

        if self.bitrate_kbps == 0:
            self.bitrate_kbps = int(
                mpeg.BITRATE_KBPS[self.version][self.layer - 1][9])
        rates = mpeg.BITRATE_KBPS[self.version][self.layer - 1]
        idx = np.where(rates == self.bitrate_kbps)[0]
        if len(idx) == 0:
            raise ValueError(
                f"bitrate {self.bitrate_kbps} invalid for layer {self.layer}")
        self.bitrate_index = int(idx[0])
        self.nchannels = 1 if self.mode == mpeg.MODE_MONO else 2
        return self

    # --- framing arithmetic (musicin.c:537-583) ---
    @property
    def bits_per_slot(self):
        return 32 if self.layer == 1 else 8

    @property
    def samples_per_frame(self):
        if self.layer == 1:
            return 384
        if self.layer == 2:
            return 1152
        return 1152 if self.version == mpeg.MPEG1 else 576

    @property
    def mode_gr(self):
        return 2 if self.version == mpeg.MPEG1 else 1

    def slots_per_frame(self):
        """(whole_slots_per_frame, fractional_part)."""
        avg = (self.samples_per_frame /
               (float(mpeg.S_FREQ_KHZ[self.version][self.sampling_frequency]))
               ) * (self.bitrate_kbps / float(self.bits_per_slot))
        whole = int(avg)
        return whole, avg - whole

    def padding_sequence(self, num_frames, true_cbr=False):
        """Deterministic per-frame padding bits.

        The reference's slot-lag algorithm (musicin.c:600-613) is dead
        code: musicin.c:567 truncates avg_slots_per_frame to its integer
        part first, so frac_SpF is always 0 and no frame is ever padded.
        Default replicates that; ``true_cbr=True`` enables the slot-lag
        padding the algorithm obviously intended, giving exact CBR.
        """
        whole, frac = self.slots_per_frame()
        padding = np.zeros(num_frames, dtype=np.int32)
        if true_cbr and frac != 0.0:
            slot_lag = -frac
            for i in range(num_frames):
                if slot_lag > frac - 1.0:
                    slot_lag -= frac
                else:
                    padding[i] = 1
                    slot_lag += 1 - frac
        return padding
