"""Ocean-dynamics framework in JAX (capabilities of Oceananigans.jl).

Finite-volume incompressible (nonhydrostatic + hydrostatic Boussinesq) and
shallow-water solvers on staggered Arakawa-C grids, built JAX/XLA-first:
immutable pytree state, jitted whole-step functions, sharding via
``jax.sharding.Mesh`` + ``shard_map`` collectives (NCCL between GPUs).
"""

from .grids.topology import PERIODIC, BOUNDED, FLAT, FULLY_CONNECTED, Topology
from .grids.rectilinear import RectilinearGrid
from .utils.location import C, F, CENTER, U_LOC, V_LOC, W_LOC
from .boundary_conditions.bcs import (
    BC, FieldBCs, Periodic, ValueBC, GradientBC, FluxBC, OpenBC,
    fill_halos, apply_flux_bcs, regularize_bcs, default_bcs,
)
from .fields.field import (
    Field, CenterField, XFaceField, YFaceField, ZFaceField, FunctionField,
    VelocityFields, TracerFields, set_field, integral, average, field_norm,
    interpolate, regrid, windowed,
)
from .fields.background import BackgroundField
from .fields.model_fields import BuoyancyField, PressureField

from .advection.schemes import (
    CenteredSecondOrder, CenteredFourthOrder, UpwindBiasedFirstOrder,
    UpwindBiasedThirdOrder, UpwindBiasedFifthOrder, WENO5,
    PositiveWENO5,
    BoundsPreservingWENO5,
)
from .coriolis.coriolis import (
    FPlane, BetaPlane, ConstantCartesianCoriolis, NonTraditionalBetaPlane,
)
from .closures.scalar_diffusivity import ScalarDiffusivity, ScalarBiharmonicDiffusivity
from .timesteppers.steppers import Clock
from .models.shallow_water import ShallowWaterModel
from .models.nonhydrostatic import NonhydrostaticModel
from .models.hydrostatic import HydrostaticFreeSurfaceModel
from .models.free_surface import (
    ExplicitFreeSurface, ImplicitFreeSurface, SplitExplicitFreeSurface,
)
from .grids.latlon import LatitudeLongitudeGrid
from .coriolis.coriolis import HydrostaticSphericalCoriolis
from .buoyancy.buoyancy import BuoyancyTracer, SeawaterBuoyancy, LinearEquationOfState
from .closures.scalar_diffusivity import (
    HorizontalScalarDiffusivity, VerticalScalarDiffusivity,
)
from .advection.vector_invariant import VectorInvariant
from .simulation.simulation import Simulation, Callback, NaNChecker, TimeStepWizard
from .utils.schedules import (
    TimeInterval, IterationInterval, WallTimeInterval, SpecifiedTimes,
    AndSchedule, OrSchedule, AveragedTimeInterval,
)
from .forcings.forcing import (
    AdvectiveForcing, Forcing, GaussianMask, LinearTarget, Relaxation,
)
from .stokes_drift import UniformStokesDrift
from .abstract_operations import (
    Average, GridMetric, Integral, KernelFunctionOperation,
    MultiaryOperation, at, compute, partial_x, partial_y, partial_z,
)
from .immersed.immersed import (GridFittedBottom, GridFittedBoundary,
                                ImmersedBoundary, PartialCellBottom)
from .particles.lagrangian import LagrangianParticles
from .output.writers import HDF5OutputWriter, NetCDFOutputWriter, WindowedTimeAverage
from .output.checkpointer import Checkpointer
from .output.readers import FieldDataset, FieldTimeSeries
from .diagnostics.diagnostics import AdvectiveCFL, CFL, DiffusiveCFL, StateChecker
from .parallel.distributed import DistributedModel, make_mesh
from .parallel.multihost import initialize_distributed, pod_mesh
from .solvers.pcg import cg_solve
from .solvers.stencil_matrix import (HeptadiagonalIterativeSolver,
                                     MultigridPoissonSolver, MultigridSolver,
                                     StencilMatrix)
from .grids.cubed_sphere import CubedSphereGrid
from .models.cubed_sphere_hydrostatic import CubedSphereHydrostaticModel
from .closures.vertical_mixing import (CATKEVerticalDiffusivity,
                                       ConvectiveAdjustmentVerticalDiffusivity,
                                       RiBasedVerticalDiffusivity)

__version__ = "0.1.0"
