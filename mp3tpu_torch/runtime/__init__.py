"""Host runtime of the port: the native bitstream assembler's binding
(``bitstream``), the Layer I/II bit allocation (``alloc12``), the WAV and
AIFF readers and the per-stage profiler."""
