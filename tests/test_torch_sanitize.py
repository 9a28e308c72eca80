"""Race/memory sanitizer CI for the port's native host library.

The port keeps its own copy of the host-analysis library
(superlu_dist_tpu_torch/native/slu_host.cpp).  Its threaded and
shared-memory paths (threaded symbolic, threaded ND, the shm tree
collectives with the failure detector's heartbeat and bulletin board)
run under ThreadSanitizer and AddressSanitizer through the port's
harness (native/sanitize_main.cpp), as tests/test_sanitize.py runs the
JAX package's: a clean report is part of the test suite.  Only a missing
toolchain may skip; a compile error in the port's sources fails.
"""

import os
import subprocess

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
NATIVE = os.path.join(HERE, "..", "superlu_dist_tpu_torch", "native")


def _sanitizer_available(tmp_path, flag) -> bool:
    """Probe with a trivial program: only a missing toolchain or runtime
    may skip."""
    probe = tmp_path / "probe.cpp"
    probe.write_text("int main() { return 0; }\n")
    try:
        r = subprocess.run(
            ["g++", f"-fsanitize={flag}", str(probe), "-o",
             str(tmp_path / "probe")],
            capture_output=True)
    except FileNotFoundError:
        return False
    return r.returncode == 0


def _build_and_run(tmp_path, flag, name):
    if not _sanitizer_available(tmp_path, flag):
        pytest.skip(f"-fsanitize={flag} toolchain unavailable")
    exe = str(tmp_path / name)
    cmd = ["g++", "-O1", "-g", f"-fsanitize={flag}", "-std=c++17",
           "-pthread", os.path.join(NATIVE, "sanitize_main.cpp"),
           os.path.join(NATIVE, "slu_host.cpp"), "-o", exe]
    r = subprocess.run(cmd, capture_output=True)
    if r.returncode != 0:
        # glibc < 2.34 keeps shm_open/shm_unlink in librt
        r = subprocess.run(cmd + ["-lrt"], capture_output=True)
    assert r.returncode == 0, r.stderr.decode()
    out = subprocess.run([exe], capture_output=True, timeout=600)
    text = out.stdout.decode() + out.stderr.decode()
    assert out.returncode == 0, text
    assert "sanitize harness PASS" in text, text
    assert "WARNING: ThreadSanitizer" not in text, text
    assert "ERROR: AddressSanitizer" not in text, text


def test_port_native_under_tsan(tmp_path):
    _build_and_run(tmp_path, "thread", "sanitize_tsan")


def test_port_native_under_asan(tmp_path):
    _build_and_run(tmp_path, "address", "sanitize_asan")
