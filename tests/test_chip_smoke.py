"""The GPU smoke script, the benchmark's device check, the case builders and
the trace-to-layer reduction, exercised on the CPU at small sizes."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
import profile_components
from breeze_tpu import cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(path, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_script_fails_without_gpu():
    out = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT,
                      {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_script_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path),
                      {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_main_refuses_cpu_backend(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "card_report", lambda: "test card, 1 W")
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_one_card_phases_small():
    lines = []
    chip_smoke.one_card_phases(scale=16, report=lines.append)
    text = "\n".join(lines)
    for phase in ("phase bomex", "phase projection", "phase compressible",
                  "phase terrain", "divergence residual"):
        assert phase in text, phase


@pytest.mark.gpu
def test_one_card_phases_full_size():
    chip_smoke.one_card_phases(report=lambda line: None)


def test_four_card_phase_on_virtual_devices():
    assert len(jax.devices()) >= 4
    lines = []
    chip_smoke.four_card_phase(scale=16, steps=2, report=lines.append)
    text = "\n".join(lines)
    assert "bomex auto_mesh" in text and "Partition(2,2)" in text


@pytest.mark.parametrize("a,b,expect", [
    (np.ones(4), np.ones(4), 0.0),
    (np.array([1.0, 2.0]), np.array([1.0, 2.5]), 0.2),
    (np.array([0.0, -4.0]), np.array([1.0, -4.0]), 0.25),
])
def test_max_rel_diff(a, b, expect):
    assert chip_smoke.max_rel_diff(a, b) == pytest.approx(expect)


def test_check_fields_rejects_out_of_bound():
    ref = {"rho_theta": np.full(3, 300.0)}
    got = {"rho_theta": np.array([300.0, 300.0, 301.0])}
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_fields("t", got, ref, chip_smoke.F32_TOL["bomex"],
                                lambda line: None)
    got = {"rho_theta": np.array([300.0, np.nan, 300.0])}
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_fields("t", got, ref, chip_smoke.F32_TOL["bomex"],
                                lambda line: None)


@pytest.mark.parametrize("platforms,ok", [("", False), ("cuda", False),
                                          ("cpu", True)])
def test_bench_device_check(monkeypatch, platforms, ok):
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if ok:
        info = bench.device_info()
        assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                        "count": len(jax.devices())}
    else:
        with pytest.raises(RuntimeError):
            bench.device_info()


def test_bench_line_names_the_device(monkeypatch, capsys):
    # keep this worker's compilations out of the persistent cache
    monkeypatch.setattr("breeze_tpu.backend.enable_compile_cache",
                        lambda: None)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert bench.main(["--size", "8x8x8", "--steps", "10",
                       "--warmup", "10"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert "vs_baseline" not in line
    assert line["value"] > 0


@pytest.mark.parametrize("build", [
    lambda: cases.bomex((8, 8, 8)),
    lambda: cases.anelastic_bubble((8, 8, 8), moist=True),
    lambda: cases.compressible_bubble((8, 8, 8)),
    lambda: cases.compressible_bubble((8, 8, 8), terrain=True,
                                      substep_floattype="bfloat16"),
], ids=["bomex", "anelastic_bubble", "compressible_bubble", "terrain_bf16"])
def test_case_builders_step(build):
    case = build()
    out = case.advance(2)(case.model, case.state)
    for name, field in chip_smoke.prognostics(out).items():
        assert field.shape == (8, 8, 8), name
        assert np.isfinite(field).all(), name


def test_case_noise_is_the_same_in_both_precisions():
    a = cases.bomex((8, 8, 8), jnp.float32)
    b = cases.bomex((8, 8, 8), jnp.float64)
    np.testing.assert_allclose(np.asarray(a.state.rho_theta),
                               np.asarray(b.state.rho_theta), rtol=1e-6)


@pytest.mark.parametrize("op_name,expect", [
    ("jit(f)/while/body/tendencies/add", "tendencies"),
    ("jit(f)/pressure_projection/poisson_solve/fft", "poisson_solve"),
    ("jit(f)/tendencies/acoustic_substeps/thomas_solve/scan", "thomas_solve"),
    ("jit(f)/mul", None),
])
def test_layer_of(op_name, expect):
    assert profile_components.layer_of(op_name) == expect


def test_trace_reduction_attributes_named_scopes(tmp_path):
    def f(x):
        with jax.named_scope("tendencies"):
            y = jnp.sin(x) * 2.0
        with jax.named_scope("pressure_projection"):
            with jax.named_scope("poisson_solve"):
                z = jnp.fft.irfft(jnp.fft.rfft(y), n=x.shape[0])
        return z + 1.0

    x = jnp.ones((4096,), jnp.float32)
    compiled = jax.jit(f).lower(x).compile()
    layers = profile_components.instruction_layers(compiled.as_text())
    assert "tendencies" in layers.values()
    assert "poisson_solve" in layers.values()
    jax.block_until_ready(compiled(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(compiled(x))
    path = next(p for p in tmp_path.rglob("*.xplane.pb"))
    summary = profile_components.reduce_trace(
        profile_components.device_events(str(path)), layers, 1)
    assert summary["layers_ms_per_step"]
    assert set(summary["layers_ms_per_step"]) <= {
        "tendencies", "poisson_solve", "other"}
    assert 0.0 < summary["busy_share"] <= 1.0
