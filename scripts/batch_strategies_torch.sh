#!/usr/bin/env bash
# Strategy-variant regression rows on the PyTorch port: the reference's
# batchSim_rbphdslam_{emptyStrat,singleStrat,clusterProc}.bash.  Seds the
# weighting-strategy key into copies of the stand-in rbphdslam2dSim.xml
# that io/sim2d_xml.py writes (as the reference scripts sed their XML,
# batchSim_rbphdslam_emptyStrat.bash:25) and runs the port's batchsim once
# per variant, at pd 0.9 and 0.5 and clutter 1e-2.
#
# Usage: scripts/batch_strategies_torch.sh [out.dat] [steps] [seeds] [batchsim args...]
#   e.g. scripts/batch_strategies_torch.sh out.dat 10 1 --particles 4 --device cpu
set -euo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-results/batch_rbphd_strategies_torch.dat}
STEPS=${2:-1500}
SEEDS=${3:-3}
shift $(( $# < 3 ? $# : 3 ))
PY=${PYTHON:-python}
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT

"$PY" -m rfs_slam_tpu_torch.io.sim2d_xml --kind rbphd --out "$TMP/base.xml" \
    > /dev/null
sed -e "s/<nEvalPt>.*<\/nEvalPt>/<nEvalPt>0<\/nEvalPt>/" \
    "$TMP/base.xml" > "$TMP/emptyStrat.xml"
sed -e "s/<nEvalPt>.*<\/nEvalPt>/<nEvalPt>1<\/nEvalPt>/" \
    "$TMP/base.xml" > "$TMP/singleStrat.xml"
sed -e "s/<useClusterProcess>.*<\/useClusterProcess>/<useClusterProcess>1<\/useClusterProcess>/" \
    "$TMP/base.xml" > "$TMP/clusterProc.xml"

for strat in emptyStrat singleStrat clusterProc; do
  echo "# strategy=$strat" >> "$OUT"
  "$PY" -m rfs_slam_tpu_torch.apps.batchsim --cfg "$TMP/$strat.xml" \
      --filter rbphd --pd 0.9 0.5 --clutter 1e-2 \
      --seeds "$SEEDS" --steps "$STEPS" --out "$OUT" "$@"
done
echo "strategy rows -> $OUT"
