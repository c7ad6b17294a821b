"""``chip_smoke.py`` on the CPU: its phases at TOY size, its refusal to
run without a GPU, and the format of its last line.  The full-size phases
run on the card (``python chip_smoke.py``)."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from primus_fhe_tpu.params import TOY, NtruParams

REPO = pathlib.Path(__file__).resolve().parents[1]

# NTRU gate geometry at a CPU size: N=64, 30-bit q, t_scale 8 encodings
NTRU_TOY = NtruParams(
    log_n=6, q_bits=30, lwe_dim=8, log_basis=8, level=3,
    ks_log_basis=7, ks_level=3, sigma=3.2, lwe_sigma=3.2,
)


@pytest.mark.parametrize("q", cs.NTT_PRIMES)
def test_phase_ntt_toy(q):
    res = cs.phase_ntt(5, 4, primes=(q,), reps=2)
    assert res[q]["roundtrips_per_s"] > 0


def test_phase_gates_toy():
    res = cs.phase_gates(TOY, 8, reps=1)
    for gate in ("NAND", "AND", "OR"):
        assert res[gate]["max_abs_err"] < 1 << 28
    assert res["key_switch_temp_bytes"] is not None


def test_phase_ntru_toy():
    assert cs.phase_ntru(NTRU_TOY, 4, reps=1)["gates_per_s"] > 0


def test_phase_dcrt_toy():
    assert cs.phase_dcrt(5, 4, 2)["cmux_per_s"] > 0


def test_phase_four_on_virtual_devices():
    """The --four comparison on four of the suite's virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    assert cs.phase_four(4, log_n=5, n_lwe=4)["sharded_ms"] > 0


def test_failed_check_raises():
    with pytest.raises(RuntimeError, match="check failed: truth table"):
        cs.check(False, "truth table")


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_cpu(argv, capsys):
    """Without a GPU the script exits non-zero before any phase and
    prints no result line."""
    with pytest.raises(SystemExit) as e:
        cs.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """A directory holding only the script cannot pass: the library is
    missing, so it exits non-zero with no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_format():
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev()])
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert "\n" not in line


@pytest.mark.gpu
def test_phases_on_gpu_match_cpu(gpu_device):
    """Card-only: the TOY phases with the device-vs-host comparisons
    running between the GPU and the CPU backend."""
    with jax.default_device(gpu_device):
        cs.phase_gates(TOY, 8, reps=1)
        cs.phase_dcrt(5, 4, 2)
