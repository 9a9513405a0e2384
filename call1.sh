#!/bin/bash
# A/B on one card: parent, final, final, parent (chip_smoke.py from each
# git-archive checkout), each run's full output under chiprun_out/.
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
i=0
for side in parent final final parent; do
  i=$((i + 1))
  ( cd scratch_checkout/$side && timeout 600 python3 chip_smoke.py ) > chiprun_out/ab${i}_${side}.txt 2>&1
  echo "run $i ($side): exit $?"
  tail -3 chiprun_out/ab${i}_${side}.txt | cut -c1-300
done
