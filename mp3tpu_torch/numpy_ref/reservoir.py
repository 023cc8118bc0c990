"""Bit reservoir accounting (reservoir.c, IS C.1.5.4.2.2)."""


class Reservoir:
    def __init__(self):
        self.size = 0
        self.max = 0

    def frame_begin(self, version, frame_bits, main_data_begin):
        resv_limit = 4088 if version == 1 else 2040
        expected = main_data_begin * 8
        assert expected == self.size, (expected, self.size)
        self.max = max(0, 7680 - frame_bits)
        self.max = min(self.max, resv_limit)

    def max_bits(self, pe, mean_bits, nchannels):
        """Per-granule budget (reservoir.c:101-134)."""
        mean = mean_bits // nchannels
        max_bits = min(mean, 4095)
        if self.max == 0:
            return max_bits
        more_bits = int(pe * 3.1 - mean)
        add_bits = 0
        if more_bits > 100:
            frac = (self.size * 6) // 10
            add_bits = min(frac, more_bits)
        over_bits = self.size - (self.max * 8) // 10 - add_bits
        if over_bits > 0:
            add_bits += over_bits
        return min(max_bits + add_bits, 4095)

    def adjust(self, mean_bits, nchannels, part2_3_length):
        self.size += mean_bits // nchannels - part2_3_length

    def frame_end(self, granules, mean_bits, nchannels, mode_gr):
        """Stuffing planning (reservoir.c:155-226).

        granules: list of GrInfo in [gr][ch] flattened order whose
        part2_3_length may be increased.  Returns resv_drain.
        """
        if nchannels == 2 and (mean_bits & 1):
            self.size += 1
        over_bits = max(0, self.size - self.max)
        self.size -= over_bits
        stuffing = over_bits
        over_bits = self.size % 8
        if over_bits:
            stuffing += over_bits
            self.size -= over_bits
        resv_drain = 0
        if stuffing:
            gi0 = granules[0]
            if gi0.part2_3_length + stuffing < 4095:
                gi0.part2_3_length += stuffing
            else:
                for gi in granules:
                    if stuffing == 0:
                        break
                    extra = 4095 - gi.part2_3_length
                    this = min(extra, stuffing)
                    gi.part2_3_length += this
                    stuffing -= this
                resv_drain = stuffing
        return resv_drain
