#!/bin/sh
# CPU test runs (tests/conftest.py pins JAX to the CPU with a virtual
# 8-device mesh; `pytest --gpu -m gpu tests/` is the on-card run).
#
# Three tiers, mirroring the reference's Float64+Float32 matrix
# (test/dependencies_for_runtests.jl:55) plus its example smoke tests
# (test/test_validation.jl):
#   tests/      f64 (x64 enabled)   - the main suite
#   tests_f32/  f32 (x64 disabled)  - benchmark-dtype correctness
#   smoke       all 11 self-checking examples + 3 cheap validation cases
#               (~3 min; SKIP_SMOKE=1 skips, e.g. for fast loops)
set -e
JAX_PLATFORMS=cpu python -m pytest tests/ -q "$@"
JAX_PLATFORMS=cpu python -m pytest tests_f32/ -q "$@"
if [ -z "$SKIP_SMOKE" ]; then
    ./examples/run_all.sh > /dev/null
    echo "examples: ALL PASS"
    for f in thermal_bubble curvilinear_diffusion wind_mixing_column; do
        JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python "validation/$f.py" > /dev/null
        echo "validation/$f: PASS"
    done
fi
