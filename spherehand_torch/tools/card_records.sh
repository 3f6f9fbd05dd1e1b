#!/bin/bash
# The port's run-level records on one card, each tool in its own processes
# sharing the card (OMP_NUM_THREADS=1 each), under the tools' deterministic
# settings, seed 0. Run from the repository root:
#
#   bash spherehand_torch/tools/card_records.sh lite [STEPS] [ARMS] [GUARD_S]
#       the arms ARMS (lite,full) of lite_mesh_e2e at STEPS (75000), one
#       process an arm, joined with --merge into
#       $RECORDS_DIR/torch_lite_mesh_e2e.json; if an arm has not
#       logged step 8000 after GUARD_S (420) seconds, every arm is
#       stopped: the run would not end within the hour.
#   bash spherehand_torch/tools/card_records.sh divergence
#       the recipe's pseudo-NYU set (reference_recipe --gen_only), then the
#       ten divergence_study probes, one process a probe, joined with
#       --merge into $RECORDS_DIR/torch_divergence_study.json (and
#       the whole study.json beside it); if a standard probe has not logged
#       iteration 1300 of its first epoch 600 seconds after the probes
#       start, every probe is stopped.
#
# Logs and records go to $RECORDS_DIR (default runs/records); data and
# checkpoints to runs/.
set -u
out=${RECORDS_DIR:-runs/records}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
export OMP_NUM_THREADS=1
start=$(date +%s)
what=${1:-}
shift || true

# watch SECONDS PID...: wait SECONDS, stopping every PID and returning 1 as
# soon as one of them has ended with a failure.
watch() {
  local until=$(( $(date +%s) + $1 )); shift
  while [ "$(date +%s)" -lt "$until" ]; do
    sleep 15
    for pid in "$@"; do
      if ! kill -0 "$pid" 2>/dev/null && ! wait "$pid"; then
        echo "process $pid failed: stopping"; kill "$@" 2>/dev/null; return 1
      fi
    done
  done
}

case "$what" in
lite)
  steps=${1:-75000}; IFS=, read -r -a arms <<< "${2:-lite,full}"
  guard_s=${3:-420}; guard_step=8000
  pids=()
  for arm in "${arms[@]}"; do
    python -m spherehand_torch.tools.lite_mesh_e2e --steps "$steps" --arms "$arm" \
      --artifact "$out/lite_$arm.json" > "$out/lite_$arm.log" 2>&1 &
    pids+=($!)
  done
  watch "$guard_s" "${pids[@]}" || { for a in "${arms[@]}"; do tail -20 "$out/lite_$a.log"; done; exit 1; }
  for arm in "${arms[@]}"; do
    if ! grep -qE "^step +$guard_step:" "$out/lite_$arm.log" && ! grep -q "held-out" "$out/lite_$arm.log"; then
      echo "arm $arm has not reached step $guard_step after $guard_s s: stopping"
      kill "${pids[@]}" 2>/dev/null
      for a in "${arms[@]}"; do echo "== $a"; tail -4 "$out/lite_$a.log"; done
      exit 5
    fi
  done
  rc=0
  for p in "${pids[@]}"; do wait "$p" || rc=1; done
  echo "${#arms[@]} arms rc=$rc in $(( $(date +%s) - start )) s"
  parts=()
  for arm in "${arms[@]}"; do echo "== $arm"; tail -5 "$out/lite_$arm.log"; parts+=("$out/lite_$arm.json"); done
  [ $rc = 0 ] && python -m spherehand_torch.tools.lite_mesh_e2e --merge "${parts[@]}" \
    --artifact "$out/torch_lite_mesh_e2e.json" && cat "$out/torch_lite_mesh_e2e.json"
  ;;
divergence)
  guard_s=600; guard_it=1300
  python -m spherehand_torch.tools.reference_recipe --gen_only > "$out/data.log" 2>&1 \
    || { tail -20 "$out/data.log"; exit 1; }
  tail -1 "$out/data.log"
  probes=(stock_instrumented lr_3e-4 lr_1e-4 no_mv_projection no_mv_consistency no_prior
          no_collision no_bone_length mv_always mv_never)
  all=$(IFS=,; echo "${probes[*]}")
  pstart=$(date +%s)
  pids=()
  for p in "${probes[@]}"; do
    skip=$(echo ",$all," | sed "s/,$p,/,/; s/^,//; s/,$//")
    python -m spherehand_torch.tools.divergence_study --out "runs/div_$p" --skip "$skip" \
      > "$out/div_$p.log" 2>&1 &
    pids+=($!)
  done
  watch "$guard_s" "${pids[@]}" || { for q in "${probes[@]}"; do tail -5 "$out/div_$q.log"; done; exit 1; }
  for p in "${probes[@]:1}"; do
    if ! grep -q "^\[0-$guard_it\]" "$out/div_$p.log" && ! grep -q "^\[1-" "$out/div_$p.log"; then
      echo "probe $p has not reached iteration $guard_it after $guard_s s: stopping"
      kill "${pids[@]}" 2>/dev/null
      for q in "${probes[@]}"; do echo "== $q"; grep -E "^\[[0-9]+-[0-9]+\]" "$out/div_$q.log" | tail -1 | cut -c1-300; done
      exit 5
    fi
  done
  rc=0
  for pid in "${pids[@]}"; do wait "$pid" || rc=1; done
  echo "ten probes rc=$rc in $(( $(date +%s) - pstart )) s"
  for p in "${probes[@]}"; do echo "== $p"; grep "^\[study\] $p\|^\[study\] stock" "$out/div_$p.log" | tail -3; done
  if [ $rc = 0 ]; then
    dirs=(); for p in "${probes[@]}"; do dirs+=("runs/div_$p"); done
    python -m spherehand_torch.tools.divergence_study --out runs/div_all --merge "${dirs[@]}" \
      --artifact "$out/torch_divergence_study.json" > "$out/div_merge.log" 2>&1 || rc=1
    tail -3 "$out/div_merge.log"
    cp runs/div_all/study.json "$out/divergence_study_full.json"
  fi
  ;;
*)
  echo "usage: card_records.sh lite|divergence ..." >&2; exit 2;;
esac
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $rc
