#!/usr/bin/env bash
# Run every example on the CPU backend; each is self-checking and prints
# "<name>: PASS". Total ~10-15 min.
set -e
cd "$(dirname "$0")"
export JAX_PLATFORMS=cpu JAX_ENABLE_X64=1
for f in one_dimensional_diffusion two_dimensional_turbulence internal_wave \
         kelvin_helmholtz_instability horizontal_convection \
         shallow_water_bickley_jet convecting_plankton \
         ocean_wind_mixing_and_convection langmuir_turbulence \
         tilted_bottom_boundary_layer baroclinic_adjustment; do
    echo "== $f"
    python "$f.py" | tail -1
done
echo "ALL EXAMPLES PASS"
