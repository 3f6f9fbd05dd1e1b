#!/bin/bash
# The port's run-level records on one card, each tool in its own processes
# sharing the card (OMP_NUM_THREADS=1 each), under the tools' deterministic
# settings, seed 0. Run from the repository root:
#
#   bash spherehand_torch/tools/card_records.sh lite [STEPS] [ARMS] [GUARD_S] [FROM] [STOP_S]
#       the arms ARMS (lite,full) of lite_mesh_e2e at STEPS (75000), one
#       process an arm, each through train_synthetic_full's resume in
#       runs/lite_resume/<arm>, so an arm longer than one call is carried
#       over calls: first the resume files that FROM/<arm> holds (what an
#       earlier call of this mode wrote to its $RECORDS_DIR) are put back.
#       If an arm has neither ended nor logged the step 8000 past where it
#       started (in the log's thousands) after GUARD_S (420) seconds, every
#       arm is stopped: it runs too slowly. STOP_S seconds after the start
#       (0, the default: never), the arms still going are stopped. Then each
#       arm's resume.json and, unless the arm has finished, its resume.pt go
#       to $RECORDS_DIR/<arm>, the FROM of the next call. Once every arm has
#       finished, their artifacts are joined with --merge into
#       $RECORDS_DIR/torch_lite_mesh_e2e.json, with the committed
#       tests/goldens/torch_lite_mesh_e2e.json (its arms as they are) when
#       that record is of STEPS and holds none of ARMS.
#   bash spherehand_torch/tools/card_records.sh divergence [SEED] [PROBES]
#       the recipe's pseudo-NYU set (reference_recipe --gen_only), then the
#       divergence_study probes PROBES (a comma list; all ten by default),
#       one process a probe, joined with --merge into
#       $RECORDS_DIR/torch_divergence_study.json (and the whole study.json
#       beside it); if a standard probe has not logged iteration 1300 of its
#       first epoch 600 seconds after the probes start, every probe is
#       stopped. With SEED (not 0): seed SEED's own split and draws
#       (runs/recipe_seed<SEED>/data, runs/div<SEED>_<probe>), the record
#       $RECORDS_DIR/torch_divergence_seed<SEED>.json.
#   bash spherehand_torch/tools/card_records.sh recipe GUARD_S [FROM]
#       the reference recipe pair (reference_recipe), carried over calls:
#       puts back the runs that FROM holds (what an earlier call of this
#       mode wrote to its $RECORDS_DIR) under runs/, writes the pseudo-NYU
#       split (--gen_only, seed 0; each run checks it by its digest), then
#       runs the stock recipe (--epochs 75, runs/reference_recipe) and the
#       companion (--lr 3e-5 --epochs 24, runs/companion_lr3e5), one process
#       each, skipping a run that has finished. GUARD_S seconds after the
#       start, the runs still going are stopped, wherever they are; a run
#       that fails stops the other. Then each run's recipe_state.json and,
#       once it has finished, its trajectory.json go to $RECORDS_DIR/<run>/,
#       the FROM of the next call, and after them the model_-1.pt of each run
#       that has not finished (what its resume reads besides the state).
#       With SEED (not 0; FROM may be ""), the companion alone at --seed
#       SEED (its own split and draws), as runs/companion_seed<SEED>.
#   bash spherehand_torch/tools/card_records.sh companion [GUARD_S]
#       the arms of tests/torch_companion_witness.py that ask where the
#       companion leaves the JAX record: writes the seed-0 split once
#       (reference_recipe --gen_only into runs/companion_arms/seed0), then
#       runs the five reference-scale arms (card_recipe_steps, _bf16,
#       _seed1, _drawseed1, _cutbatch) and the cut-size card_cut_cardhands,
#       one process each; an arm that fails leaves the others going. GUARD_S
#       (2100) seconds after the start, the arms still going are stopped
#       wherever they are (each arm's JSON holds every eval it took). Each
#       arm's runs/companion_arms/<arm>.json and the card-written cut hands
#       (card_data.tar.gz) go to $RECORDS_DIR, and the witness's --report
#       reads them there.
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

# watch SECONDS PID...: wait SECONDS, or until every PID has ended, saying
# when each ends; as soon as one of them has ended with a failure, stop them
# all and return 1 (with KEEP_GOING=1: say so, let the others go on, and
# return 1 at the end).
watch() {
  local until=$(( $(date +%s) + $1 )) pid alive failed=0; shift
  local -A ended=()
  while :; do
    alive=0
    for pid in "$@"; do
      [ -n "${ended[$pid]:-}" ] && continue
      if kill -0 "$pid" 2>/dev/null; then alive=1; continue; fi
      ended[$pid]=1
      if ! wait "$pid"; then
        [ "${KEEP_GOING:-0}" = 1 ] || { echo "process $pid failed: stopping"; kill "$@" 2>/dev/null; return 1; }
        echo "process $pid failed at $(( $(date +%s) - start )) s"; failed=1; continue
      fi
      echo "process $pid ended at $(( $(date +%s) - start )) s"
    done
    [ $alive = 1 ] && [ "$(date +%s)" -lt "$until" ] || return $failed
    sleep 5
  done
}

case "$what" in
lite)
  steps=${1:-75000}; IFS=, read -r -a arms <<< "${2:-lite,full}"
  guard_s=${3:-420}; from=${4:-}; stop_s=${5:-0}; guard_step=8000; dir=runs/lite_resume
  record=tests/goldens/torch_lite_mesh_e2e.json
  pids=(); parts=()
  for arm in "${arms[@]}"; do
    if [ -n "$from" ] && [ -d "$from/$arm" ]; then
      mkdir -p "$dir/$arm" && cp -r "$from/$arm/." "$dir/$arm/" && echo "put back $dir/$arm from $from/$arm"
    fi
    rm -f "$out/lite_$arm.json"
    python -m spherehand_torch.tools.lite_mesh_e2e --steps "$steps" --arms "$arm" --resume "$dir" \
      --artifact "$out/lite_$arm.json" > "$out/lite_$arm.log" 2>&1 &
    pids+=($!); parts+=("$out/lite_$arm.json")
  done
  watch "$guard_s" "${pids[@]}" || { for a in "${arms[@]}"; do tail -20 "$out/lite_$a.log"; done; exit 1; }
  for arm in "${arms[@]}"; do
    first=$(sed -n 's/^resumed at step \([0-9]*\) .*/\1/p' "$out/lite_$arm.log")
    want=$(( (${first:-0} + guard_step) / 1000 * 1000 ))
    [ "$want" -lt "$steps" ] || want=$(( steps - 1 ))
    if ! grep -qE "^step +$want:" "$out/lite_$arm.log" && ! grep -q "held-out" "$out/lite_$arm.log"; then
      echo "arm $arm has not reached step $want after $guard_s s: stopping"
      kill "${pids[@]}" 2>/dev/null
      for a in "${arms[@]}"; do echo "== $a"; tail -4 "$out/lite_$a.log"; done
      exit 5
    fi
  done
  rc=0
  if [ "$stop_s" -gt 0 ]; then
    watch $(( stop_s - ($(date +%s) - start) )) "${pids[@]}" || rc=1
  fi
  for i in "${!pids[@]}"; do
    if [ $rc = 0 ] && kill -0 "${pids[$i]}" 2>/dev/null && [ "$stop_s" -gt 0 ]; then
      echo "guard: stopping ${arms[$i]} at $(( $(date +%s) - start )) s"; kill "${pids[$i]}"
      wait "${pids[$i]}"
    else
      wait "${pids[$i]}" || rc=1
    fi
  done
  echo "${#arms[@]} arms rc=$rc in $(( $(date +%s) - start )) s"
  ended=1
  for arm in "${arms[@]}"; do
    echo "== $arm"; tail -5 "$out/lite_$arm.log"
    mkdir -p "$out/$arm"
    [ -f "$dir/$arm/resume.json" ] && cp "$dir/$arm/resume.json" "$out/$arm/"
    if [ ! -f "$out/lite_$arm.json" ]; then
      ended=0; [ -f "$dir/$arm/resume.pt" ] && cp "$dir/$arm/resume.pt" "$out/$arm/"
    fi
  done
  if [ $rc = 0 ] && [ $ended = 1 ]; then
    base=$(python -c 'import json, sys; r = json.load(open(sys.argv[1]))
print(sys.argv[1] if r["steps"] == int(sys.argv[2]) and not set(sys.argv[3:]) & set(r) else "")' \
      "$record" "$steps" "${arms[@]}")
    python -m spherehand_torch.tools.lite_mesh_e2e --merge $base "${parts[@]}" \
      --artifact "$out/torch_lite_mesh_e2e.json" && cat "$out/torch_lite_mesh_e2e.json" || rc=1
  fi
  ;;
divergence)
  guard_s=600; guard_it=1300; seed=${1:-0}
  all_probes=(stock_instrumented lr_3e-4 lr_1e-4 no_mv_projection no_mv_consistency no_prior
              no_collision no_bone_length mv_always mv_never)
  all=$(IFS=,; echo "${all_probes[*]}")
  IFS=, read -r -a probes <<< "${2:-$all}"
  if [ "$seed" = 0 ]; then
    recipe=runs/reference_recipe; runs=runs/div; record=torch_divergence_study.json
  else
    recipe=runs/recipe_seed$seed; runs=runs/div$seed; record=torch_divergence_seed$seed.json
  fi
  seeded=(--data "$recipe/data" --seed "$seed")
  python -m spherehand_torch.tools.reference_recipe --gen_only --seed "$seed" --out "$recipe" \
    > "$out/data.log" 2>&1 || { tail -20 "$out/data.log"; exit 1; }
  tail -1 "$out/data.log"
  pstart=$(date +%s)
  pids=()
  for p in "${probes[@]}"; do
    skip=$(echo ",$all," | sed "s/,$p,/,/; s/^,//; s/,$//")
    python -m spherehand_torch.tools.divergence_study "${seeded[@]}" --out "${runs}_$p" \
      --skip "$skip" > "$out/div_$p.log" 2>&1 &
    pids+=($!)
  done
  watch "$guard_s" "${pids[@]}" || { for q in "${probes[@]}"; do tail -5 "$out/div_$q.log"; done; exit 1; }
  for p in "${probes[@]}"; do
    [ "$p" = stock_instrumented ] && continue
    if ! grep -q "^\[0-$guard_it\]" "$out/div_$p.log" && ! grep -q "^\[1-" "$out/div_$p.log"; then
      echo "probe $p has not reached iteration $guard_it after $guard_s s: stopping"
      kill "${pids[@]}" 2>/dev/null
      for q in "${probes[@]}"; do echo "== $q"; grep -E "^\[[0-9]+-[0-9]+\]" "$out/div_$q.log" | tail -1 | cut -c1-300; done
      exit 5
    fi
  done
  rc=0
  for pid in "${pids[@]}"; do wait "$pid" || rc=1; done
  echo "${#probes[@]} probes rc=$rc in $(( $(date +%s) - pstart )) s"
  for p in "${probes[@]}"; do echo "== $p"; grep "^\[study\] $p\|^\[study\] stock" "$out/div_$p.log" | tail -3; done
  if [ $rc = 0 ]; then
    dirs=(); for p in "${probes[@]}"; do dirs+=("${runs}_$p"); done
    # the probes not asked for are skipped, not run, by the merge
    rest=$(IFS=,; echo ",$all,"); for p in "${probes[@]}"; do rest=${rest/,$p,/,}; done
    rest=${rest#,}; rest=${rest%,}
    python -m spherehand_torch.tools.divergence_study "${seeded[@]}" --out "${runs}_all" \
      --merge "${dirs[@]}" --skip "$rest" --artifact "$out/$record" > "$out/div_merge.log" 2>&1 \
      || rc=1
    tail -3 "$out/div_merge.log"
    cp "${runs}_all/study.json" "$out/${record%.json}_full.json"
  fi
  ;;
recipe)
  guard_s=${1:?usage: card_records.sh recipe GUARD_S [FROM] [SEED]}; from=${2:-}; seed=${3:-0}
  if [ "$seed" = 0 ]; then
    names=(reference_recipe companion_lr3e5)
    flags=("--epochs 75" "--lr 3e-5 --epochs 24")
  else
    names=("companion_seed$seed")
    flags=("--lr 3e-5 --epochs 24 --seed $seed")
  fi
  for n in "${names[@]}"; do
    if [ -n "$from" ] && [ -d "$from/$n" ]; then
      mkdir -p "runs/$n" && cp -r "$from/$n/." "runs/$n/" && echo "put back runs/$n from $from/$n"
    fi
  done
  python -m spherehand_torch.tools.reference_recipe --gen_only --seed "$seed" \
    --out "runs/${names[0]}" > "$out/data.log" 2>&1 || { tail -20 "$out/data.log"; exit 1; }
  tail -2 "$out/data.log"
  if [ "$seed" = 0 ]; then
    mkdir -p runs/companion_lr3e5 && ln -sfn ../reference_recipe/data runs/companion_lr3e5/data
  fi
  pids=(); running=()
  for i in "${!names[@]}"; do
    n=${names[$i]}
    if [ -f "runs/$n/trajectory.json" ]; then echo "$n has finished"; continue; fi
    # shellcheck disable=SC2086
    python -m spherehand_torch.tools.reference_recipe ${flags[$i]} --out "runs/$n" \
      > "$out/$n.log" 2>&1 &
    pids+=($!); running+=("$n"); echo "$n runs as process $!"
  done
  rc=0
  watch $(( guard_s - ($(date +%s) - start) )) "${pids[@]}" || rc=1
  for i in "${!pids[@]}"; do
    if [ $rc = 0 ] && kill -0 "${pids[$i]}" 2>/dev/null; then
      echo "guard: stopping ${running[$i]} at $(( $(date +%s) - start )) s"; kill "${pids[$i]}"
    fi
  done
  wait
  # The small files of both runs before any checkpoint, and a checkpoint only
  # for a run that has not finished: a finished run's resume reads nothing.
  for n in "${names[@]}"; do
    [ -f "runs/$n/recipe_state.json" ] || continue
    mkdir -p "$out/$n"
    cp "runs/$n/recipe_state.json" "$out/$n/"
    [ -f "runs/$n/trajectory.json" ] && cp "runs/$n/trajectory.json" "$out/$n/"
  done
  for n in "${names[@]}"; do
    state="runs/$n/recipe_state.json"
    [ -f "$state" ] || continue
    run=$(python -c 'import json, sys; print(json.load(open(sys.argv[1]))["run_name"])' "$state")
    if [ ! -f "runs/$n/trajectory.json" ] && [ -f "runs/$n/runs/$run/model_-1.pt" ]; then
      mkdir -p "$out/$n/runs/$run" && cp "runs/$n/runs/$run/model_-1.pt" "$out/$n/runs/$run/"
    fi
    echo "== $n"
    [ -f "$out/$n.log" ] && grep -E "^\[[0-9]+-[0-9]+\]" "$out/$n.log" | tail -1 | cut -c1-400
    python - "$state" <<'EOF'
import json, sys
s = json.load(open(sys.argv[1]))
print(json.dumps({k: s[k] for k in ("next_epoch", "steps", "train_secs", "pending", "calls")}))
print(json.dumps(s["trajectory"][-3:]))
EOF
  done
  echo "recipe pair rc=$rc in $(( $(date +%s) - start )) s"
  ;;
companion)
  guard_s=${1:-2100}; work=runs/companion_arms
  arms=(card_recipe_steps card_recipe_bf16 card_recipe_seed1 card_recipe_drawseed1
        card_recipe_cutbatch card_cut_cardhands)
  python -c 'from spherehand_torch import cuda_build as b; b.build_all(b.SOURCES)' || exit 1
  python -m spherehand_torch.tools.reference_recipe --gen_only --out "$work/seed0" \
    > "$out/data.log" 2>&1 || { tail -20 "$out/data.log"; exit 1; }
  tail -1 "$out/data.log"
  pids=()
  for arm in "${arms[@]}"; do
    PYTHONPATH=. python tests/torch_companion_witness.py --work "$work" --arm "$arm" \
      > "$out/$arm.log" 2>&1 &
    pids+=($!); echo "$arm runs as process $!"
  done
  rc=0
  KEEP_GOING=1 watch $(( guard_s - ($(date +%s) - start) )) "${pids[@]}" || rc=1
  for i in "${!pids[@]}"; do
    if kill -0 "${pids[$i]}" 2>/dev/null; then
      echo "guard: stopping ${arms[$i]} at $(( $(date +%s) - start )) s"; kill "${pids[$i]}"; rc=1
    fi
  done
  wait
  for arm in "${arms[@]}"; do
    [ -f "$work/$arm.json" ] && cp "$work/$arm.json" "$out/"
    echo "== $arm"; grep -v "^\[engine\]\|^\[[0-9]*-[0-9]*\]:" "$out/$arm.log" | tail -3 | cut -c1-300
  done
  [ -d "$work/card_data" ] && tar czf "$out/card_data.tar.gz" -C "$work" card_data
  PYTHONPATH=. python tests/torch_companion_witness.py --work "$out" --report
  echo "companion arms rc=$rc in $(( $(date +%s) - start )) s"
  ;;
*)
  echo "usage: card_records.sh lite|divergence|recipe|companion ..." >&2; exit 2;;
esac
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $rc
