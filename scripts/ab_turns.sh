#!/usr/bin/env bash
# A/B of this checkout against another commit, in turns (other, this, this,
# other) on one card. Each round runs this checkout's `chip_smoke.py
# --kernels-only` against that round's kernels (phase 8: every kernel
# direction's wrapper, enqueue and profiled device time, with the SM clock),
# then `scripts/argmax_channel_sweep.py` (kernel 1 over channel counts),
# `scripts/eval_batch_time.py` (DeeplabMulti batch of 4, Oracle batch of 2)
# and `scripts/train_step_time.py` in source-only and multi-level mode.
#
#   mkdir -p _archive/parent && git archive <commit> | tar -x -C _archive/parent
#   chiprun --timeout 1500 -- bash scripts/ab_turns.sh _archive/parent
#
# The log goes to chiprun_out/ab.log; a line "FAILED <round> <what>" marks
# a run that exited nonzero.
set -u
other=${1:?usage: scripts/ab_turns.sh DIR (an unpacked copy of the other commit)}
mkdir -p chiprun_out
cp chip_smoke.py "$other/chip_smoke_ab.py"
exec > chiprun_out/ab.log 2>&1
for round in other this this other; do
  if [ "$round" = other ]; then root=$other; smoke=chip_smoke_ab.py
  else root=.; smoke=chip_smoke.py; fi
  echo "=== round $round kernels"
  (cd "$root" && python3 "$smoke" --kernels-only) || echo "FAILED $round kernels"
  echo "=== round $round argmax channels"
  python3 scripts/argmax_channel_sweep.py --root "$root" --tag "$round" \
    || echo "FAILED $round argmax channels"
  echo "=== round $round eval"
  python3 scripts/eval_batch_time.py --root "$root" --tag "$round" \
    || echo "FAILED $round eval"
  for mode in source-only multi-level; do
    echo "=== round $round train $mode"
    python3 scripts/train_step_time.py --mode "$mode" --root "$root" \
      --tag "$round" || echo "FAILED $round train $mode"
  done
done
