#!/usr/bin/env bash
# The two-step MS-CNN training schedule on the port (the reference's
# examples/*/*/train_mscnn.sh): stage 1 trains the proposal sub-network
# (from VGG16 ImageNet weights when given), stage 2 warm-starts the joint
# detection net from stage 1's last snapshot. Works with the reference's
# own solver prototxts.
#
# Usage: train_mscnn.sh <model_dir> [vgg16.caffemodel] [cli train options...]
#   model_dir holds solver_1st.prototxt and solver_2nd.prototxt (e.g. a
#   checkout of the reference's examples/kitti_car/mscnn-8s-768-trainval);
#   the options after the two positional arguments go to both
#   `python3 -m mscnn_torch.cli train` calls (e.g. --device cpu, --bf16).
#   MSCNN_PYTHON names the command that runs those calls (default python3;
#   its first word runs the snapshot lookup).

set -euo pipefail
dir="${1:?usage: $0 <model_dir> [vgg16.caffemodel] [cli train options...]}"
shift
vgg=""
if [ $# -gt 0 ] && [[ "$1" != -* ]]; then
  vgg="$1"
  shift
fi

# the package importable from anywhere, any PYTHONPATH entries kept
repo="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="${repo}${PYTHONPATH:+:$PYTHONPATH}"
read -r -a py <<< "${MSCNN_PYTHON:-python3}"

cd "$dir"
w1=()
[ -n "$vgg" ] && w1=(--weights "$vgg")

"${py[@]}" -m mscnn_torch.cli train --solver solver_1st.prototxt ${w1[@]+"${w1[@]}"} "$@" \
  2>&1 | tee log_1st.txt

# stage 2 warm-starts from the stage-1 snapshot (snapshot_prefix of
# solver_1st.prototxt); `cli train2` runs both stages and wires the warm
# start itself: stage 1 is run on its own here to mirror the reference
# script's two calls.
snap="$("${py[0]}" - <<'PY'
from mscnn_torch.config import prototxt as PB
from mscnn_torch.io import checkpoint as CKPT
fields = PB.parse_prototxt_file("solver_1st.prototxt")
print(CKPT.latest_snapshot(str(fields.get("snapshot_prefix", "mscnn"))) or "")
PY
)"
if [ -z "$snap" ]; then
  echo "train_mscnn.sh: no stage-1 snapshot found" >&2
  exit 1
fi
"${py[@]}" -m mscnn_torch.cli train --solver solver_2nd.prototxt --weights "$snap" "$@" \
  2>&1 | tee log_2nd.txt
