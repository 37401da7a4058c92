#!/bin/bash
# Runs chip_smoke.py from each checkout named on the command line, one
# after the other on the same card, and prints the card's name and power
# limit, then for each checkout its exit code, its command seconds, its
# last line and its "wall" line.  Each run's output goes to
# chiprun_out/<checkout's base name>_full.log (and .err).
#
#   ./chip_smoke_pair.sh scratch_archive/parent scratch_archive/change
set -u
root=$(cd "$(dirname "$0")" && pwd)
out="$root/chiprun_out"
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$@"; do
  name=$(basename "$tree")
  start=$(date +%s.%N)
  (cd "$tree" && python3 chip_smoke.py > "$out/${name}_full.log" \
    2> "$out/${name}_full.err")
  rc=$?
  end=$(date +%s.%N)
  echo "$name rc=$rc command_seconds=$(awk "BEGIN {print $end - $start}")"
  tail -n 1 "$out/${name}_full.log"
  grep '"phase": "wall"' "$out/${name}_full.log" | cut -c1-400
done
