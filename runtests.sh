#!/bin/bash
# Test runner: the suite on the CPU with 8 virtual devices (conftest.py sets
# both unless JAX_PLATFORMS says otherwise).  xdist workers both parallelize
# and isolate the sporadic XLA:CPU compile aborts of this jaxlib — a crashed
# worker is reported and replaced instead of killing the whole run.  Any test
# that FAILED (usually because its worker crashed mid-compile) is retried
# once serially; the retry verdict is final.
set -o pipefail
# ./runtests.sh --contract : the <5-min contract tier — rest states,
# conservation, sharded==dense, Poisson manufactured solutions, the jnp-path
# contracts of every configuration.  CI should run this on every change and the full
# suite nightly.
# ./runtests.sh --nightly : the default suite PLUS the long physics tier
# (example --check runs + validation smokes; ~40 min extra on this host).
if [ "$1" = "--nightly" ]; then
    shift
    set -- tests/ -n 2 --nightly "$@"
fi
if [ "$1" = "--contract" ]; then
    shift
    set -- \
        tests/test_compressible.py::TestRestState \
        tests/test_compressible.py::TestConservation \
        tests/test_compressible_static_energy.py::TestRestState \
        tests/test_anelastic_model.py::TestRestState \
        tests/test_anelastic_model.py::TestConservation \
        tests/test_poisson.py \
        tests/test_distributed.py \
        tests/test_jnp_paths.py \
        tests/test_jnp_acoustic.py \
        -n 4 "$@"
fi
if [ $# -eq 0 ]; then
    # 4 workers (one per core, 125 GB RAM is no constraint) + generous
    # worker-restart budget for the jaxlib XLA:CPU segfault flake
    set -- tests/ -n 4 --max-worker-restart=12
fi
export JAX_PLATFORMS=cpu
LOG=$(mktemp "${TMPDIR:-/tmp}/runtests.XXXXXX.log")
python -m pytest "$@" -q 2>&1 | tee "$LOG"
status=$?
if [ $status -ne 0 ]; then
    mapfile -t failed < <(grep -E "^FAILED " "$LOG" | awk '{print $2}' | sort -u)
    if [ ${#failed[@]} -gt 0 ] && [ ${#failed[@]} -le 20 ]; then
        echo "--- retrying ${#failed[@]} failed test(s) serially (XLA:CPU segfault flake isolation) ---"
        python -m pytest "${failed[@]}" -q -p no:xdist
        status=$?
    fi
fi
rm -f "$LOG"
exit $status
