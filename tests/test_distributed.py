"""Distributed execution tests on an 8-virtual-device CPU mesh.

The key contract (SURVEY.md §4): sharded and single-device runs agree
allclose.  Exercises both execution paths — GSPMD (jit + NamedSharding) and
the explicit shard_map halo exchange.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import breeze_tpu as bz
from breeze_tpu import fields as fl
from breeze_tpu.model import initial_state, make_model
from breeze_tpu.parallel.halo import pad_axis_sharded, shard_axes
from breeze_tpu.parallel.mesh import (device_put_replicated_model,
                                      device_put_sharded_state, factor_mesh,
                                      make_mesh, shard_step, state_sharding)
from breeze_tpu.timesteppers import ssp_rk3_step


@pytest.fixture(autouse=True)
def _eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def bomex_like(nx=32, ny=16, nz=8):
    g = bz.make_grid(size=(nx, ny, nz), extent=(6400.0, 3200.0, 1600.0),
                     topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                     dtype=jnp.float32)
    model = make_model(g, advection=bz.WENO(5), potential_temperature=300.0,
                      microphysics=bz.SaturationAdjustment(
                          equilibrium=bz.WarmPhaseEquilibrium()),
                      coriolis=bz.FPlane(1e-4))

    def theta0(x, y, z):
        return (300.0 + 1.5 * jnp.exp(-((x - 3200.0) ** 2 + (y - 1600.0) ** 2
                                        + (z - 500.0) ** 2) / 400.0 ** 2))

    state = initial_state(model, theta=theta0,
                          qt=lambda x, y, z: 0.01 * jnp.exp(-z / 1000.0))
    return model, state


class TestMeshHelpers:
    def test_factor_mesh(self):
        assert factor_mesh(8) in ((4, 2), (2, 4))
        assert factor_mesh(4) == (2, 2)
        assert factor_mesh(1) == (1, 1)

    def test_make_mesh(self):
        mesh = make_mesh(jax.devices()[:8])
        assert set(mesh.axis_names) == {"x", "y"}
        assert mesh.devices.size == 8


class TestGSPMD:
    def test_sharded_step_matches_single_device(self):
        """The core distributed contract: sharded == single-device."""
        model, state = bomex_like()
        ref_state = jax.jit(ssp_rk3_step)(model, state, 2.0)
        for _ in range(2):
            ref_state = jax.jit(ssp_rk3_step)(model, ref_state, 2.0)

        mesh = make_mesh(jax.devices()[:8])
        model_s = device_put_replicated_model(mesh, model)
        state_s = device_put_sharded_state(mesh, state)
        step = shard_step(lambda m, s, dt: ssp_rk3_step(m, s, dt), mesh,
                          model_s, state_s, donate=False)
        out = state_s
        for _ in range(3):
            out = step(model_s, out, 2.0)

        np.testing.assert_allclose(np.asarray(out.rho_theta),
                                   np.asarray(ref_state.rho_theta),
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(out.rho_w),
                                   np.asarray(ref_state.rho_w),
                                   rtol=2e-4, atol=1e-4)

    def test_output_stays_sharded(self):
        model, state = bomex_like()
        mesh = make_mesh(jax.devices()[:8])
        model_s = device_put_replicated_model(mesh, model)
        state_s = device_put_sharded_state(mesh, state)
        step = shard_step(lambda m, s, dt: ssp_rk3_step(m, s, dt), mesh,
                          model_s, state_s, donate=False)
        out = step(model_s, state_s, 1.0)
        shard_shape = out.rho_theta.sharding.shard_shape(out.rho_theta.shape)
        assert shard_shape[1] < out.rho_theta.shape[1] or \
            shard_shape[2] < out.rho_theta.shape[2], "fields must stay sharded"


class TestShardMapHalo:
    def test_ppermute_halo_matches_wrap(self):
        """shard_map halo exchange reproduces the single-device wrap pad."""
        n_dev = 8
        mesh = jax.make_mesh((n_dev,), ("x",))
        nx = 64
        a = jnp.arange(4 * 4 * nx, dtype=jnp.float32).reshape(4, 4, nx)
        h = 3

        def local_pad(block):
            with shard_axes({2: "x"}):
                return pad_axis_sharded(block, 2, h)

        padded_shards = jax.jit(
            jax.shard_map(local_pad, mesh=mesh,
                          in_specs=P(None, None, "x"),
                          out_specs=P(None, None, "x")))(a)
        # Each shard's padded block: [left-nbr top h | shard | right-nbr bottom h]
        # Reassemble shard 0's halo and compare with the global wrap pad.
        per_shard = nx // n_dev
        shard0 = np.asarray(padded_shards)[:, :, : per_shard + 2 * h]
        expected_left = np.asarray(a[:, :, -h:])        # global wrap
        np.testing.assert_array_equal(shard0[:, :, :h], expected_left)
        np.testing.assert_array_equal(shard0[:, :, h:h + per_shard],
                                      np.asarray(a[:, :, :per_shard]))
        np.testing.assert_array_equal(shard0[:, :, h + per_shard:],
                                      np.asarray(a[:, :, per_shard:per_shard + h]))

    def test_sharded_stencil_matches_dense(self):
        """A derivative computed per-shard with exchanged halos equals the
        single-device operator."""
        n_dev = 4
        mesh = jax.make_mesh((n_dev,), ("x",))
        g = bz.make_grid(size=(32, 4, 4), extent=(2 * np.pi, 1.0, 1.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float64)
        x = jnp.asarray(g.x_c())[None, None, :]
        c = jnp.sin(x) * jnp.ones(g.shape)

        from breeze_tpu.ops import StencilOps
        so = StencilOps(g)
        dense = so.dx_cf(fl.pad(c, g, fl.CCC))

        def local_dx(block):
            with shard_axes({2: "x"}):
                p = pad_axis_sharded(block, 2, g.halo)
            # same stencil arithmetic, local window
            return (p[:, :, g.halo:-g.halo] - p[:, :, g.halo - 1:-g.halo - 1]) / g.dx

        sharded = jax.jit(
            jax.shard_map(local_dx, mesh=mesh,
                          in_specs=P(None, None, "x"),
                          out_specs=P(None, None, "x")))(c)
        np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                                   atol=1e-13)


class TestShardMapProductionStep:
    """The full anelastic step under shard_map with explicit collectives
    (ppermute halos + all_to_all pencil FFT) — parallel/shard_step.py."""

    def _setup(self):
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float32)
        model = make_model(g, advection=bz.WENO(5),
                           potential_temperature=300.0,
                           microphysics=bz.SaturationAdjustment(
                               equilibrium=bz.WarmPhaseEquilibrium()),
                           coriolis=bz.FPlane(1e-4))
        state = initial_state(
            model,
            theta=lambda x, y, z: 300.0 + 1.5 * jnp.exp(
                -((x - 3200.) ** 2 + (y - 1600.) ** 2
                  + (z - 500.) ** 2) / 400.0 ** 2),
            qt=lambda x, y, z: 0.01 * jnp.exp(-z / 1000.0))
        return model, state

    def test_shard_map_step_matches_dense(self):
        from breeze_tpu.parallel.shard_step import (make_shard_map_step,
                                                    make_x_mesh)
        model, state = self._setup()
        ref = state
        for _ in range(3):
            ref = jax.jit(ssp_rk3_step, static_argnums=2)(model, ref, 2.0)
        step = make_shard_map_step(model, make_x_mesh(4))
        out = state
        for _ in range(3):
            out = step(out, 2.0)
        np.testing.assert_allclose(np.asarray(out.rho_theta),
                                   np.asarray(ref.rho_theta),
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(out.rho_qt),
                                   np.asarray(ref.rho_qt),
                                   rtol=2e-4, atol=1e-8)
        np.testing.assert_allclose(np.asarray(out.rho_w),
                                   np.asarray(ref.rho_w),
                                   rtol=2e-4, atol=1e-4)

    def test_shard_map_full_bomex_forcings_matches_dense(self):
        """Canonical BOMEX forcing set (geostrophic + subsidence + drying +
        sponge) under shard_map == dense (round-4 VERDICT weak #1): the
        mean-based forcings must use GLOBAL horizontal means (pmean over
        mesh axes), not shard-local ones.  The off-center bubble makes the
        local shard means differ strongly, so this fails without
        forcings.horizontal_mean.  Reference: subsidence_forcing.jl:14-137
        (means are global under MPI)."""
        from breeze_tpu.parallel.shard_step import (make_shard_map_step,
                                                    make_x_mesh)
        from breeze_tpu.physics.forcings import (DrySubsidenceTendency,
                                                 GeostrophicForcing,
                                                 SubsidenceForcing,
                                                 UpperSponge)
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float32)
        model = make_model(
            g, advection=bz.WENO(5), potential_temperature=300.0,
            microphysics=bz.SaturationAdjustment(
                equilibrium=bz.WarmPhaseEquilibrium()),
            coriolis=bz.FPlane(1e-4),
            forcings=(
                GeostrophicForcing(f=1e-4, u_g=lambda z: -10.0 + 1.8e-3 * z),
                SubsidenceForcing(w_profile=lambda z: -0.004 * z / 1600.0),
                DrySubsidenceTendency(
                    tendency_profile=lambda z: jnp.where(z < 600.0,
                                                         -1.2e-8, 0.0)),
                UpperSponge(rate=0.05, bottom=1000.0, damp_scalars=True),
            ))
        # bubble at x=1200 m: x-shards see very different local means
        state = initial_state(
            model,
            theta=lambda x, y, z: 300.0 + 1.5 * jnp.exp(
                -((x - 1200.0) ** 2 + (y - 1600.0) ** 2
                  + (z - 500.0) ** 2) / 400.0 ** 2),
            qt=lambda x, y, z: 0.01 * jnp.exp(-z / 1000.0),
            u=lambda x, y, z: 2.0 * jnp.sin(2 * jnp.pi * x / 6400.0))
        ref = state
        for _ in range(3):
            ref = jax.jit(ssp_rk3_step, static_argnums=2)(model, ref, 2.0)
        step = make_shard_map_step(model, make_x_mesh(4))
        out = state
        for _ in range(3):
            out = step(out, 2.0)
        for name in ("rho_theta", "rho_qt", "rho_u", "rho_v", "rho_w"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)),
                np.asarray(getattr(ref, name)),
                rtol=2e-4, atol=2e-4, err_msg=name)

    def test_pencil_poisson_matches_dense_solver(self):
        from breeze_tpu.parallel.shard_step import (PencilPoissonSolver,
                                                    make_x_mesh)
        from breeze_tpu.parallel.halo import shard_axes
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float32)
        model = make_model(g, potential_temperature=300.0)
        rng = np.random.default_rng(3)
        div = jnp.asarray(rng.normal(size=g.shape).astype(np.float32))
        dense = model.solver.solve(div, 2.0)
        mesh = make_x_mesh(4)
        pencil = PencilPoissonSolver(base=model.solver, nx_global=g.nx)
        sharded = jax.jit(jax.shard_map(
            lambda d: pencil.solve(d, 2.0), mesh=mesh,
            in_specs=P(None, None, "x"), out_specs=P(None, None, "x")))(div)
        np.testing.assert_allclose(np.asarray(sharded), np.asarray(dense),
                                   rtol=3e-4, atol=3e-4)

    @pytest.mark.parametrize("transform,vertical",
                             [("real", "scan"), ("real", "eigen")])
    def test_pencil_poisson_real_basis_matches_dense(self, transform,
                                                     vertical):
        """The real-eigenbasis paths (the GPU default is real + eigen)
        through the pencil transposes, on a 1-D and a 2-D mesh."""
        from breeze_tpu.dynamics.poisson import build_anelastic_poisson_solver
        from breeze_tpu.parallel.shard_step import (PencilPoissonSolver,
                                                    make_x_mesh, make_xy_mesh)
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         dtype=jnp.float64)
        model = make_model(g, potential_temperature=300.0)
        base = build_anelastic_poisson_solver(
            g, model.reference.rho_c, model.reference.rho_f,
            transform=transform, vertical_solve=vertical)
        rng = np.random.default_rng(4)
        div = jnp.asarray(rng.normal(size=g.shape))
        div = div - jnp.mean(div)
        dense = base.solve(div, 2.0)
        for mesh, ay, spec in (
                (make_x_mesh(4), None, P(None, None, "x")),
                (make_xy_mesh(2, 2), "y", P(None, "y", "x"))):
            pencil = PencilPoissonSolver(base=base, axis_y=ay,
                                         nx_global=g.nx, ny_global=g.ny)
            sharded = jax.jit(jax.shard_map(
                lambda d: pencil.solve(d, 2.0), mesh=mesh,
                in_specs=spec, out_specs=spec))(div)
            a = np.asarray(sharded) - float(jnp.mean(sharded))
            b = np.asarray(dense) - float(jnp.mean(dense))
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-10 * np.abs(b).max())

    def test_partition_2d_matches_dense(self):
        """Partition(px=2, py=2): both horizontal axes decomposed — halos
        on x AND y via ppermute, Poisson through the two-axis pencil
        transposes (reference ``Partition(px, py)``, src/Breeze.jl:208)."""
        from breeze_tpu.parallel.shard_step import (make_shard_map_step,
                                                    make_xy_mesh)
        model, state = self._setup()
        ref = state
        for _ in range(3):
            ref = jax.jit(ssp_rk3_step, static_argnums=2)(model, ref, 2.0)
        step = make_shard_map_step(model, make_xy_mesh(2, 2))
        out = state
        for _ in range(3):
            out = step(out, 2.0)
        for name, rtol, atol in (("rho_theta", 2e-5, 1e-4),
                                 ("rho_qt", 2e-4, 1e-8),
                                 ("rho_u", 2e-4, 1e-4),
                                 ("rho_v", 2e-4, 1e-4),
                                 ("rho_w", 2e-4, 1e-4)):
            np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=rtol, atol=atol, err_msg=name)

    def test_bounded_y_shard_map_matches_dense(self):
        """Bounded-y topology on the explicit-collective path: the DCT/real
        eigenbasis transform runs on the fully gathered horizontals inside
        the pencil solve; y-halos use the bounded mirror rules."""
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.BOUNDED, bz.BOUNDED),
                         dtype=jnp.float32)
        model = make_model(g, advection=bz.WENO(5),
                           potential_temperature=300.0)
        state = initial_state(
            model,
            theta=lambda x, y, z: 300.0 + 1.5 * jnp.exp(
                -((x - 3200.) ** 2 + (y - 1600.) ** 2
                  + (z - 500.) ** 2) / 400.0 ** 2))
        assert model.solver.transform == "real"
        from breeze_tpu.parallel.shard_step import (make_shard_map_step,
                                                    make_x_mesh)
        ref = state
        for _ in range(3):
            ref = jax.jit(ssp_rk3_step, static_argnums=2)(model, ref, 2.0)
        step = make_shard_map_step(model, make_x_mesh(4))
        out = state
        for _ in range(3):
            out = step(out, 2.0)
        for name in ("rho_theta", "rho_u", "rho_v", "rho_w"):
            np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                       np.asarray(getattr(ref, name)),
                                       rtol=2e-4, atol=2e-4, err_msg=name)


class TestBlessedDistributedEntry:
    """ONE documented production multi-device path — Simulation auto-wraps
    the step via make_distributed_step (shard_map) when >1 device is
    visible."""

    def test_auto_mesh_prefers_1d_x(self):
        from breeze_tpu.parallel.shard_step import auto_mesh
        model, _ = bomex_like(nx=32, ny=16, nz=8)
        mesh = auto_mesh(model)           # 8 devices: nx%8, ny%8, nz%8 ok
        assert mesh is not None and mesh.devices.shape == (8,)
        # pencil constraint violated (nz=12 not divisible by 8 -> no 1-D;
        # 2-D candidates also need px*py | nz) -> None
        g = bz.make_grid(size=(32, 16, 12), extent=(6400.0, 3200.0, 1600.0),
                         dtype=jnp.float32,
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED))
        m2 = make_model(g, potential_temperature=300.0)
        assert auto_mesh(m2, 8) is None

    def test_simulation_auto_distributes_matches_dense(self):
        from breeze_tpu.simulation import Simulation
        model, state = bomex_like(nx=32, ny=16, nz=8)
        ref_sim = Simulation(model, state, dt=2.0, stop_iteration=3,
                             verbose=False, distributed=False)
        assert ref_sim.mesh is None
        ref_sim.run()
        sim = Simulation(model, state, dt=2.0, stop_iteration=3,
                         verbose=False, distributed=True)
        assert sim.mesh is not None, "auto-distribution did not engage"
        sim.run()
        np.testing.assert_allclose(np.asarray(sim.state.rho_theta),
                                   np.asarray(ref_sim.state.rho_theta),
                                   rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(sim.state.rho_w),
                                   np.asarray(ref_sim.state.rho_w),
                                   rtol=2e-4, atol=1e-4)


class TestShardedBoundedHalo:
    def test_bounded_center_pad_matches_dense(self):
        from breeze_tpu.parallel.halo import (pad_axis_sharded_bounded,
                                              shard_axes)
        mesh = jax.make_mesh((4,), ("x",))
        a = jnp.arange(4 * 2 * 32, dtype=jnp.float32).reshape(4, 2, 32)
        h = 3
        dense = np.asarray(fl.pad_axis(a, 2, h, bz.Topology.BOUNDED, fl.C))

        def local(block):
            with shard_axes({2: "x"}):
                return pad_axis_sharded_bounded(block, 2, h, face=False)

        padded = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=P(None, None, "x"),
            out_specs=P(None, None, "x")))(a)
        # reassemble: shard s block is dense[..., s*8 : s*8 + 8 + 2h] in the
        # padded global coordinate system
        per = 32 // 4
        blocks = np.split(np.asarray(padded), 4, axis=2)
        for s, b in enumerate(blocks):
            np.testing.assert_array_equal(b, dense[:, :, s * per:s * per + per + 2 * h])

    def test_bounded_face_pad_matches_dense(self):
        from breeze_tpu.parallel.halo import (pad_axis_sharded_bounded,
                                              shard_axes)
        mesh = jax.make_mesh((4,), ("x",))
        a = jnp.arange(4 * 2 * 32, dtype=jnp.float32).reshape(4, 2, 32)
        h = 3
        dense = np.asarray(fl.pad_axis(a, 2, h, bz.Topology.BOUNDED, fl.F))

        def local(block):
            with shard_axes({2: "x"}):
                return pad_axis_sharded_bounded(block, 2, h, face=True)

        padded = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=P(None, None, "x"),
            out_specs=P(None, None, "x")))(a)
        per = 32 // 4
        blocks = np.split(np.asarray(padded), 4, axis=2)
        for s, b in enumerate(blocks):
            np.testing.assert_array_equal(b, dense[:, :, s * per:s * per + per + 2 * h])

    def test_wrap_roll_matches_dense_roll(self):
        from breeze_tpu.parallel.halo import shard_axes, wrap_roll
        mesh = jax.make_mesh((4,), ("x",))
        a = jnp.arange(2 * 2 * 32, dtype=jnp.float32).reshape(2, 2, 32)
        for shift in (1, -1):
            dense = np.asarray(jnp.roll(a, shift, 2))

            def local(block, shift=shift):
                with shard_axes({2: "x"}):
                    return wrap_roll(block, shift, 2)

            out = jax.jit(jax.shard_map(
                local, mesh=mesh, in_specs=P(None, None, "x"),
                out_specs=P(None, None, "x")))(a)
            np.testing.assert_array_equal(np.asarray(out), dense)


class TestGSPMDCompressible:
    """Sharded == single-device for the split-explicit compressible core —
    the most communication-dense path (6+ halo fills per acoustic substep
    in the reference, acoustic_substepping.jl:1423-1510)."""

    def _model(self, terrain=False):
        from breeze_tpu.dynamics.compressible import (
            SplitExplicitTimeDiscretization, compressible_initial_state,
            make_compressible_model)
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         halo=3, dtype=jnp.float32)
        terr = None
        if terrain:
            from breeze_tpu.dynamics.terrain import make_terrain
            terr = make_terrain(
                g, bz.ThermodynamicConstants(),
                lambda x, y: 150.0 / (1.0 + ((x - 3200.0) / 800.0) ** 2
                                      + ((y - 1600.0) / 800.0) ** 2))
        model = make_compressible_model(
            g, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
            terrain=terr,
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        state = compressible_initial_state(
            model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
                -((x - 3200.0) ** 2 + (y - 1600.0) ** 2
                  + (z - 500.0) ** 2) / 400.0 ** 2),
            u=lambda x, y, z: 3.0 + 0 * x)
        return model, state

    def _run(self, terrain):
        from breeze_tpu.dynamics.compressible import acoustic_rk3_step
        model, state = self._model(terrain)
        dt = 0.5
        step1 = jax.jit(lambda m, s: acoustic_rk3_step(m, s, dt))
        ref = state
        for _ in range(3):
            ref = step1(model, ref)

        mesh = make_mesh(jax.devices()[:8])
        model_s = device_put_replicated_model(mesh, model)
        state_s = device_put_sharded_state(mesh, state)
        step = shard_step(lambda m, s, _dt: acoustic_rk3_step(m, s, dt),
                          mesh, model_s, state_s, donate=False)
        out = state_s
        for _ in range(3):
            out = step(model_s, out, dt)
        for name in ("rho", "rho_u", "rho_w", "rho_theta"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)),
                np.asarray(getattr(ref, name)),
                rtol=3e-5, atol=3e-4, err_msg=name)

    def test_flat_sharded_matches_single_device(self):
        self._run(terrain=False)

    def test_terrain_sharded_matches_single_device(self):
        self._run(terrain=True)


class TestShardMapCompressible:
    """Split-explicit compressible core on the EXPLICIT shard_map path
    (ppermute halos through the acoustic fast loop — the reference's
    6-exchanges-per-substep MPI pattern, acoustic_substepping.jl:1423-1510).
    GSPMD coverage exists above; this pins the production explicit-collective
    path (round-4 VERDICT item 5)."""

    def _run(self, terrain, mesh_fn, n_steps=3):
        from breeze_tpu.dynamics.compressible import acoustic_rk3_step
        from breeze_tpu.parallel.shard_step import make_shard_map_step
        model, state = TestGSPMDCompressible()._model(terrain)
        dt = 0.5
        ref = state
        step1 = jax.jit(lambda m, s: acoustic_rk3_step(m, s, dt))
        for _ in range(n_steps):
            ref = step1(model, ref)
        step = make_shard_map_step(model, mesh_fn())
        out = state
        for _ in range(n_steps):
            out = step(out, dt)
        for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)),
                np.asarray(getattr(ref, name)),
                rtol=3e-5, atol=3e-4, err_msg=name)

    def test_flat_1d_matches_dense(self):
        from breeze_tpu.parallel.shard_step import make_x_mesh
        self._run(False, lambda: make_x_mesh(4))

    def test_sponge_forcing_matches_dense(self):
        """Compressible shard_map with the mean-relaxing UpperSponge forcing
        (round-4 VERDICT item 1): the ⟨ρu⟩/⟨ρv⟩/⟨ρθ⟩ relaxation targets
        must be global means under decomposition."""
        from breeze_tpu.dynamics.compressible import (
            SplitExplicitTimeDiscretization, acoustic_rk3_step,
            compressible_initial_state, make_compressible_model)
        from breeze_tpu.parallel.shard_step import (make_shard_map_step,
                                                    make_x_mesh)
        from breeze_tpu.physics.forcings import UpperSponge
        g = bz.make_grid(size=(32, 16, 8), extent=(6400.0, 3200.0, 1600.0),
                         topology=(bz.PERIODIC, bz.PERIODIC, bz.BOUNDED),
                         halo=3, dtype=jnp.float32)
        model = make_compressible_model(
            g, advection=bz.WENO(5), coriolis=bz.FPlane(1e-4),
            forcings=(UpperSponge(rate=0.08, bottom=800.0,
                                  damp_scalars=True),),
            time_discretization=SplitExplicitTimeDiscretization(substeps=4))
        # off-center bubble + shear → local shard means differ
        state = compressible_initial_state(
            model, theta=lambda x, y, z: 300.0 + 1.0 * jnp.exp(
                -((x - 1200.0) ** 2 + (y - 1600.0) ** 2
                  + (z - 500.0) ** 2) / 400.0 ** 2),
            u=lambda x, y, z: 3.0 + 2.0 * jnp.sin(2 * jnp.pi * x / 6400.0))
        dt = 0.5
        ref = state
        step1 = jax.jit(lambda m, s: acoustic_rk3_step(m, s, dt))
        for _ in range(3):
            ref = step1(model, ref)
        step = make_shard_map_step(model, make_x_mesh(4))
        out = state
        for _ in range(3):
            out = step(out, dt)
        for name in ("rho", "rho_u", "rho_v", "rho_w", "rho_theta"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name)),
                np.asarray(getattr(ref, name)),
                rtol=3e-5, atol=3e-4, err_msg=name)

    def test_flat_2d_partition_matches_dense(self):
        from breeze_tpu.parallel.shard_step import make_xy_mesh
        self._run(False, lambda: make_xy_mesh(2, 2))

    def test_terrain_1d_matches_dense(self):
        from breeze_tpu.parallel.shard_step import make_x_mesh
        self._run(True, lambda: make_x_mesh(4))

    def test_terrain_2d_partition_matches_dense(self):
        from breeze_tpu.parallel.shard_step import make_xy_mesh
        self._run(True, lambda: make_xy_mesh(2, 2))
