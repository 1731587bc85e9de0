"""Runtime analysis of the port's dispatch path: the jit sanitizer
(``jit_sanitizer``), which classifies every instrumented dispatch as a
cold first call, a hit or a retrace and arms CUDA's sync debug mode around
a step region."""
