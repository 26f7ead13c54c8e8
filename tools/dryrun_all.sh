#!/bin/bash
# Every dry-run cell of the port, as parallel chains of single cells (one
# process a cell, one chain an arch, JOBS chains at once), then
# `python -m repro_torch.launch.dryrun --all --both-meshes` once more, which
# reuses the records the chains wrote and prints the summary.  CPU work on
# meta tensors; no card is needed.
#
#   bash tools/dryrun_all.sh [OUT_DIR] [JOBS]     # from the repo root
#
# OUT_DIR defaults to results/dryrun_torch, JOBS to 7; each chain's output
# goes to OUT_DIR/logs/<arch>.log.
cd "$(dirname "$0")/.."
out=${1:-results/dryrun_torch}
jobs=${2:-7}
mkdir -p "$out/logs"
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__)'
nproc
chain() {
  for mp in "" "--multi-pod"; do
    for s in decode_32k long_500k prefill_32k train_4k; do
      PYTHONPATH=src python -m repro_torch.launch.dryrun --arch "$1" \
        --shape "$s" $mp --out "$out" >> "$out/logs/$1.log" 2>&1
    done
  done
}
export -f chain
export out
t0=$(date +%s)
PYTHONPATH=src python -c 'from repro_torch.configs import ARCH_IDS; print("\n".join(ARCH_IDS))' \
  | xargs -P "$jobs" -I{} bash -c 'chain {}'
echo "chains: $(( $(date +%s) - t0 )) s"
PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
  --out "$out" > "$out/logs/all.log" 2>&1
rc=$?
tail -1 "$out/logs/all.log"
exit $rc
