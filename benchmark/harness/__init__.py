"""The benchmark's own machinery: inputs from the seed, work counts and
peaks, the reduction of a profiler trace, and the comparison that decides
``correct``."""
