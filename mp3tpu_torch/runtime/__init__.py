"""Host runtime of the port: the native bitstream assembler's binding
(``bitstream``), the Layer I/II bit allocation (``alloc12``), the WAV and
AIFF readers, the per-stage profiler with its torch.profiler trace and
named program spans (``profiling``), and the libmpg123 binding
(``mpg123``), the independent decoder of the conformance checks."""
