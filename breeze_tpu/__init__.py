"""breeze_tpu: an atmospheric LES / mesoscale framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference Breeze.jl (NumericalEarth/Breeze.jl): anelastic and compressible
moist dynamical cores, moist thermodynamics, microphysics, LES closures,
surface physics, and distributed (device-mesh) execution.

Quickstart (mirrors reference README.md:64-79):

    import breeze_tpu as bz
    grid = bz.make_grid(size=(256, 1, 256), extent=(2e4, 1.0, 1e4),
                        topology=(bz.PERIODIC, bz.FLAT, bz.BOUNDED))
    model = bz.make_model(grid, advection=bz.WENO(5), potential_temperature=300.0)
    state = bz.initial_state(model, theta=lambda x, y, z: 300.0 + bubble(x, z))
    state = bz.ssp_rk3_step(model, state, dt=1.0)
"""

from .grid import (BOUNDED, FLAT, PERIODIC, Grid, Topology, make_grid,
                   piecewise_stretched_z)
from .advection import (WENO, Centered, FluxFormAdvection, UpwindBiased,
                        AdaptiveImplicitVerticalAdvection)
from .model import AtmosphereModel, State, compute_tendencies, diagnose, initial_state, make_model, pressure_projection, stage_update
from .timesteppers import many_steps, ssp_rk3_step, step_jit
from .thermo.constants import IdealGas, CondensedPhase, MoistureMassFractions, ThermodynamicConstants
from .thermo.reference import ReferenceState, make_reference_state
from .thermo.saturation import MixedPhaseEquilibrium, WarmPhaseEquilibrium
from .physics.microphysics import SaturationAdjustment
from .physics.bulk import (ConstantRateCondensateFormation,
                           NonEquilibriumCloudFormation)
from .physics.coriolis import (BetaPlane, ConstantCartesianCoriolis, FPlane,
                               HydrostaticSphericalCoriolis,
                               NonTraditionalBetaPlane, SphericalCoriolis)
from .simulation import (Checkpointer, FieldTimeSeries, FieldWriter,
                         HDF5Writer, IterationInterval, NetCDFWriter,
                         Simulation, SpecifiedTimes, TimeInterval,
                         WallTimeInterval, conjure_time_step_wizard)
from .parallel.shard_step import (auto_mesh, initialize_distributed,
                                  make_distributed_step)

__version__ = "0.1.0"
