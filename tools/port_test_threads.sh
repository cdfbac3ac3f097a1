#!/bin/bash
# Wall time of port test files on the CPU, one process alone and then
# several copies at once, as tier-1's xdist workers run them side by side.
#
#     tools/port_test_threads.sh CHECKOUT TAG [COPIES] [FILE ...]
#
# CHECKOUT: a directory holding the repository (e.g. a `git archive` of
# another commit, with .urs_cache/ and .jax_cache/ copied beside it); TAG
# names the logs, written to $LOGDIR (default: the current directory).
# COPIES defaults to 6 (0: each file alone only), the files to
# tests/test_torch_errors.py and tests/test_torch_chain.py.  Each run takes
# tier-1's pytest flags without xdist and is capped at 1,800 s.  Prints
# one line per file and mode: seconds, and each copy's pytest summary.
set -u
checkout=$1
tag=$2
copies=${3:-6}
shift $(( $# < 3 ? $# : 3 ))
files=("$@")
[ ${#files[@]} -eq 0 ] && files=(tests/test_torch_errors.py tests/test_torch_chain.py)
logdir=$(cd "${LOGDIR:-.}" && pwd)
cd "$checkout"
for f in "${files[@]}"; do
  b=$(basename "$f" .py)
  s=$(date +%s.%N)
  timeout -k 10 1800 env JAX_PLATFORMS=cpu ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest "$f" -q -m 'not slow' \
    -p no:cacheprovider -p no:randomly > "$logdir/${tag}_${b}_one.log" 2>&1
  rc=$?
  e=$(date +%s.%N)
  echo "$tag $f one: rc=$rc $(awk "BEGIN{print $e - $s}") s $(tail -n1 "$logdir/${tag}_${b}_one.log")"
  [ "$copies" -eq 0 ] && continue
  s=$(date +%s.%N)
  for i in $(seq "$copies"); do
    timeout -k 10 1800 env JAX_PLATFORMS=cpu ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest "$f" -q -m 'not slow' \
      -p no:cacheprovider -p no:randomly > "$logdir/${tag}_${b}_copy$i.log" 2>&1 &
  done
  wait
  e=$(date +%s.%N)
  echo "$tag $f $copies at once: $(awk "BEGIN{print $e - $s}") s; $(tail -qn1 "$logdir/${tag}_${b}"_copy*.log | tr '\n' '|')"
done
