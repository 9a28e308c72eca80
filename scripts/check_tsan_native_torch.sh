#!/usr/bin/env bash
# check_tsan_native_torch.sh — ThreadSanitizer gate for the port's native
# host library (superlu_dist_tpu_torch/native/slu_host.cpp).  Builds the
# port's harness (native/sanitize_main.cpp) with -fsanitize=thread in a
# temporary directory and runs it: the threaded symbolic and ND paths,
# the shared-memory tree collectives and the failure detector's
# heartbeat / pid atomics and bulletin-board seqlock, under deliberate
# cross-thread contention.  tests/test_torch_sanitize.py runs the same
# harness under TSan and ASan.
#
# Exit 0 = pass, non-zero = a failure, diagnostics on stdout/stderr.
# When the toolchain cannot build TSan binaries the gate prints SKIP and
# exits 0: the SKIP line is the evidence the gate ran.
#
# Usage: scripts/check_tsan_native_torch.sh
set -uo pipefail
cd "$(dirname "$0")/.."

NATIVE=superlu_dist_tpu_torch/native
TMP="$(mktemp -d "${TMPDIR:-/tmp}/slu_tsan_torch.XXXXXX")"
trap 'rm -rf "$TMP"' EXIT

# toolchain probe: only a missing compiler/TSan runtime may SKIP — a
# compile failure in OUR sources must FAIL the gate, not disable it
printf 'int main(){return 0;}\n' > "$TMP/probe.cpp"
if ! g++ -fsanitize=thread "$TMP/probe.cpp" -o "$TMP/probe" 2>/dev/null \
    || ! "$TMP/probe"; then
  echo "check_tsan_native_torch: SKIP (TSan toolchain unavailable)"
  exit 0
fi

echo "check_tsan_native_torch: building harness (-fsanitize=thread)..."
build() {
  g++ -O1 -g -fsanitize=thread -std=c++17 -pthread \
    "$NATIVE/sanitize_main.cpp" "$NATIVE/slu_host.cpp" \
    -o "$TMP/sanitize_tsan" "$@" 2> "$TMP/build.err"
}
# glibc < 2.34 keeps shm_open/shm_unlink in librt
if ! build && ! build -lrt; then
  echo "check_tsan_native_torch: FAIL (harness build error)" >&2
  cat "$TMP/build.err" >&2
  exit 1
fi

# halt_on_error keeps the report next to the failure; exitcode != 0 on
# any race so the gate contract holds even without output scraping
out="$TMP/run.log"
if ! TSAN_OPTIONS="halt_on_error=1 exitcode=66" \
    timeout -k 10 300 "$TMP/sanitize_tsan" > "$out" 2>&1; then
  echo "check_tsan_native_torch: FAIL (harness exited non-zero)" >&2
  cat "$out" >&2
  exit 1
fi
if grep -q "WARNING: ThreadSanitizer" "$out"; then
  echo "check_tsan_native_torch: FAIL (ThreadSanitizer report)" >&2
  cat "$out" >&2
  exit 1
fi
if ! grep -q "PASS" "$out"; then
  echo "check_tsan_native_torch: FAIL (harness did not report PASS)" >&2
  cat "$out" >&2
  exit 1
fi
echo "check_tsan_native_torch: OK ($(grep -c . "$out") line(s); collectives + heartbeat/bulletin/seqlock stress clean under TSan)"
