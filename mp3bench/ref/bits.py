"""Bit access for the plain parsers: a byte string read MSB first, with
O(1) peeks of up to 24 bits."""
import numpy as np

PEEK = 24


class Bits:
    """Bits of `data` (bytes or uint8 array); ``pos`` is a bit index."""

    def __init__(self, data, pos=0):
        b = np.unpackbits(np.frombuffer(bytes(data), np.uint8)).astype(np.int64)
        self.n = len(b)
        padded = np.concatenate([b, np.zeros(PEEK, np.int64)])
        # win[p] = the PEEK bits starting at p, as an integer
        win = np.zeros(self.n + 1, np.int64)
        for k in range(PEEK):
            win = (win << 1) | padded[k:k + self.n + 1]
        self.win = win.tolist()
        self.pos = pos

    def peek(self, n):
        return self.win[self.pos] >> (PEEK - n)

    def get(self, n):
        if n == 0:
            return 0
        v = 0
        while n > PEEK:
            v = (v << PEEK) | self.win[self.pos]
            self.pos += PEEK
            n -= PEEK
        v = (v << n) | (self.win[self.pos] >> (PEEK - n))
        self.pos += n
        return v


def crc16(fields, crc=0xFFFF):
    """The CRC-16 of ISO/IEC 11172-3 2.4.3.1 (polynomial 0x8005, start
    0xFFFF) over (value, width) fields, MSB first."""
    for value, width in fields:
        for k in range(width - 1, -1, -1):
            bit = (value >> k) & 1
            top = (crc >> 15) & 1
            crc = (crc << 1) & 0xFFFF
            if top ^ bit:
                crc ^= 0x8005
    return crc
