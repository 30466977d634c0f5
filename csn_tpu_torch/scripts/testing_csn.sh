#!/usr/bin/env bash
# Evaluate one or all 17 PartNet categories with the port's CSN model, then
# aggregate the per-category IoUs with the port's collect_partnet_results
# (the port's form of `MinkowskiNet/scripts/testing_csn.sh:1-40`).
#
#   bash csn_tpu_torch/scripts/testing_csn.sh <Category|all|--show_categories> <K> [base_dir]
#
# base_dir (default outputs/) is searched per category for the newest run
# dir holding a checkpoint of the port (weights.pt or checkpoint_*.pt, the
# layout of train_csn.sh's LOG_DIR); LOG_DIR=... overrides one category's
# dir. `all` aggregates the runs it evaluated and no other result under
# base_dir. DEVICE (default cuda) goes to every evaluation (DEVICE=cpu: the
# CPU). `all` fails only when no category was evaluated; a named category
# that fails fails the script. On N cards, run test_csn.sh's command under
# torchrun per category (see its header).
set -eo pipefail

source "$(dirname "$0")/partnet_categories.sh"

SHOW_CATS="--show_categories"
MODEL=${MODEL:-HRNetSimCSN3S}

if [ -z "$1" ]; then
  echo "Usage: $0 <Category|all|$SHOW_CATS> <K> [base_dir]" >&2
  exit 1
fi

if [ "$1" = "$SHOW_CATS" ]; then
  echo "PartNet categories with L3 annotations:"
  echo "---------------------------------------"
  for i in "${!CATEGORIES[@]}"; do
    echo -e "\t$((i + 1)).\t${CATEGORIES[$i]}"
  done
  exit 0
fi

if [ -z "$2" ]; then
  echo "Specify the number of neighbors (0 for SSA, 1/2/3 for CSA)" >&2
  exit 1
fi

CAT=$1
K_NEIGHBORS=$2
BASE=${3:-outputs}
DATAPATH=${DATAPATH:-"./data/partnet"}
export DEVICE=${DEVICE:-cuda}

resolve_log_dir() {
  # newest run dir under $BASE/**/<category>/<model>-K<k>/** holding a ckpt
  local cat=$1
  find "$BASE" -path "*/${cat}/${MODEL}-K${K_NEIGHBORS}/*" \
      \( -name "weights.pt" -o -name "checkpoint_*.pt" \) \
      -printf '%T@ %h\n' 2>/dev/null | sort -rn | head -1 | cut -d' ' -f2-
}

if [ "$CAT" = "all" ] && [ -n "${LOG_DIR:-}" ]; then
  echo "ERROR: LOG_DIR is a single-category override — with 'all' it would" >&2
  echo "evaluate every category against the same checkpoint dir. Unset it." >&2
  exit 1
fi

FOUND=false
FAILED=()
# a link to each evaluation this run made: the aggregate reads these and
# nothing else under $BASE (other models, other K, older runs)
EVALUATED=$(mktemp -d)
trap 'rm -rf "$EVALUATED"' EXIT
for i in "${!CATEGORIES[@]}"; do
  C=${CATEGORIES[$i]}
  if [ "$CAT" = "$C" ] || [ "$CAT" = "all" ]; then
    FOUND=true
    DIR=${LOG_DIR:-$(resolve_log_dir "$C")}
    if [ -z "$DIR" ]; then
      echo "!!! no checkpoint found for ${C} under ${BASE} — skipping" >&2
      FAILED+=("$C")
      continue
    fi
    echo "=== ${C}: evaluating ${DIR} (K=${K_NEIGHBORS})"
    if SAVE_PRED_DIR="${DIR}/${C}_evaluation/results" \
        bash "$(dirname "$0")/test_csn.sh" "$C" "$DIR" "$K_NEIGHBORS"; then
      ln -s "$(cd "$DIR" && pwd)/${C}_evaluation" "$EVALUATED/${C}_evaluation"
    else
      FAILED+=("$C")
    fi
  fi
done

if [ "$FOUND" = false ]; then
  echo "ERROR: '$CAT' is not a PartNet category with L3 annotations" >&2
  exit 1
fi

if [ "$CAT" = "all" ]; then
  echo "=== aggregate (collect_partnet_results over the runs evaluated above)"
  python -m csn_tpu_torch.tasks.collect_partnet_results \
    --results_root "$EVALUATED" \
    --pattern "{cat}_evaluation/results/results_log.txt" || true
  if [ "${#FAILED[@]}" -gt 0 ]; then
    echo "!!! categories with no result: ${FAILED[*]}" >&2
  fi
  # fail only when NOTHING evaluated (partial collections still aggregate)
  if [ "${#FAILED[@]}" -eq "${#CATEGORIES[@]}" ]; then
    exit 1
  fi
else
  # single named category: its failure IS the script's failure (callers and
  # session drivers key on the exit code)
  if [ "${#FAILED[@]}" -gt 0 ]; then
    echo "!!! evaluation failed for: ${FAILED[*]}" >&2
    exit 1
  fi
fi
