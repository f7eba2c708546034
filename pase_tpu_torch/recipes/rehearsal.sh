#!/usr/bin/env bash
# Production rehearsal through the PyTorch port's CLIs: every subsystem of
# a pretraining run surviving the others across process lifecycles (the
# training loop and its AuxiliarSuperviser probes, a SIGKILL, a resume in
# a new process, export and serving). The steps and assertions of
# recipes/rehearsal.sh, each command a `python -m pase_tpu_torch.*` one:
#
#   1. build a synthetic on-disk corpus and its distortion assets
#      (pase_tpu_torch.make_bench_corpus)
#   2. compute ZNorm trainset statistics (make_trainset_statistics)
#   3. control run A: train --device_corpus EPOCHS epochs, uninterrupted
#      (on a card with a second uninterrupted run A2 beside it)
#   4. rehearsal run B: the same seed and corpus, with --sup_exec firing a
#      real speaker-ID probe (run_probe utt) on epoch boundaries; kill -9
#      once a step of epoch 2 is logged; resume in a new process; finish
#   5. assert A's and B's final FE_e*.npz are equal bit for bit (on a
#      card without deterministic algorithms: within twice the spread
#      of A and A2)
#   6. export a serving artifact from B's final checkpoint
#      (util_scripts export)
#   7. assert serve-encode == forward-chunk within 2e-4 on a corpus wav
#      (forward-chunk in windows of the export's bucket)
#   8. assert the supervised probe ran, and that the pretrained encoder
#      beats chance and a random-init encoder of the same architecture
#
# Usage:  bash pase_tpu_torch/recipes/rehearsal.sh [WORK_DIR]
#   HOURS=2 EPOCHS=5 BATCH=32 CHUNK=32000: corpus size and run length
#   FE_CFG, WK_CFG: the encoder and worker cfgs (PASE+ / workers+)
#   DEVICE=cuda: where every CLI runs (cpu for a narrow run on the CPU)
# The training runs log every step (--log_freq 1): the kill waits for a
# logged step of epoch 2, which is the evidence that the run is past
# epoch 1's save and not yet at the last one. Writes a PASS / FAIL
# transcript to $WORK/rehearsal.log.
set -euo pipefail

REPO=$(cd "$(dirname "$0")/../.." && pwd)
WORK=${1:-${TMPDIR:-/tmp}/pase_torch_rehearsal}
HOURS=${HOURS:-2}
EPOCHS=${EPOCHS:-5}
BATCH=${BATCH:-32}
CHUNK=${CHUNK:-32000}
FE_CFG=${FE_CFG:-$REPO/cfg/frontend/PASE+.cfg}
WK_CFG=${WK_CFG:-$REPO/cfg/workers/workers+.cfg}
DEVICE=${DEVICE:-cuda}
LAST=$((EPOCHS - 1))

mkdir -p "$WORK"
WORK=$(cd "$WORK" && pwd)
LOG=$WORK/rehearsal.log
cd "$REPO"
: > "$LOG"
note() { echo "[rehearsal] $*" | tee -a "$LOG"; }
fail() { note "FAIL: $*"; exit 1; }
# a failure ends the runs still going beside it
trap 'kill $(jobs -p) 2> /dev/null || true' EXIT
if [ "$EPOCHS" -lt 3 ]; then
    fail "EPOCHS=$EPOCHS: the kill lands in epoch 2, so at least 3 are needed"
fi
T0=$(date +%s.%N)
lap() {     # the seconds since the last lap, as one line of the transcript
    local now
    now=$(date +%s.%N)
    note "step $1 took $(awk -v a="$T0" -v b="$now" \
        'BEGIN { printf "%.1f", b - a }') s"
    T0=$now
}

# ---- 1. corpus ------------------------------------------------------------
if [ ! -f "$WORK/corpus/data.cfg" ]; then
    note "building ${HOURS}h synthetic corpus"
    python -m pase_tpu_torch.make_bench_corpus --out_root "$WORK/corpus" \
        --hours "$HOURS" | tee -a "$LOG"
fi
lap "1 (corpus)"

# ---- 2. trainset statistics ------------------------------------------------
if [ ! -f "$WORK/stats.pkl" ]; then
    note "computing ZNorm statistics"
    python -m pase_tpu_torch.make_trainset_statistics \
        --data_root "$WORK/corpus/wavs" --data_cfg "$WORK/corpus/data.cfg" \
        --net_cfg "$WK_CFG" --out_file "$WORK/stats.pkl" --max_batches 10 \
        --chunk_size "$CHUNK" --device "$DEVICE" | tail -2 | tee -a "$LOG"
fi
lap "2 (statistics)"

# ---- probe lists: speaker ID on the synthetic corpus -----------------------
python - "$WORK" <<'PY'
import collections
import os
import sys
work = sys.argv[1]
wavs = sorted(os.listdir(os.path.join(work, "corpus", "wavs")))
by_spk = collections.defaultdict(list)
for w in wavs:
    by_spk[w.split("-")[0]].append(w)
tr, te = [], []
for spk, files in sorted(by_spk.items())[:10]:   # 10 speakers is plenty
    te += [(f, spk) for f in files[:2]]
    tr += [(f, spk) for f in files[2:8]]
with open(os.path.join(work, "probe_tr.lst"), "w") as f:
    f.write("".join(f"{w} {s}\n" for w, s in tr))
with open(os.path.join(work, "probe_te.lst"), "w") as f:
    f.write("".join(f"{w} {s}\n" for w, s in te))
print(f"[rehearsal] probe lists: {len(tr)} train / {len(te)} test utts")
PY

cat > "$WORK/sup_cmd.txt" <<EOF
python -m pase_tpu_torch.run_probe utt --fe_cfg $FE_CFG --fe_ckpt \$model --train_list $WORK/probe_tr.lst --test_list $WORK/probe_te.lst --data_root $WORK/corpus/wavs --epochs 5 --device $DEVICE --out \$save_path/probe_\$iteration.json
EOF

TRAIN_ARGS=(--data_root "$WORK/corpus/wavs" --data_cfg "$WORK/corpus/data.cfg"
    --dtrans_cfg "$WORK/corpus/dist.cfg" --net_cfg "$WK_CFG"
    --fe_cfg "$FE_CFG" --stats "$WORK/stats.pkl" --device_corpus
    --batch_size "$BATCH" --chunk_size "$CHUNK" --epoch "$EPOCHS"
    --seed 42 --log_freq 1 --device "$DEVICE")

# step 8's random-init probe needs no training: it runs beside the runs
python -m pase_tpu_torch.run_probe utt --fe_cfg "$FE_CFG" \
    --train_list "$WORK/probe_tr.lst" --test_list "$WORK/probe_te.lst" \
    --data_root "$WORK/corpus/wavs" --epochs 5 --device "$DEVICE" \
    --out "$WORK/probe_random.json" >> "$WORK/probe_random.log" 2>&1 &
RANDOM_PID=$!

# ---- 3. control run A (uninterrupted) --------------------------------------
# On a card a second uninterrupted run, A2, runs beside A: where the card's
# algorithms are not deterministic, step 5 reads the run-to-run spread
# from it (on the CPU the runs are deterministic and A2 is not run)
A2_PID=""
if [ "$DEVICE" != cpu ]; then
    rm -rf "$WORK/runA2"
    python -m pase_tpu_torch.train "${TRAIN_ARGS[@]}" \
        --save_path "$WORK/runA2" >> "$WORK/runA2.log" 2>&1 &
    A2_PID=$!
fi
if [ ! -f "$WORK/runA/FE_e$LAST.npz" ]; then
    note "run A: $EPOCHS uninterrupted epochs${A2_PID:+ (run A2 beside it)}"
    python -m pase_tpu_torch.train "${TRAIN_ARGS[@]}" \
        --save_path "$WORK/runA" >> "$LOG" 2>&1
fi
if [ -n "$A2_PID" ]; then
    wait "$A2_PID" || fail "run A2 failed: see $WORK/runA2.log"
fi
lap "3 (run A)"

# ---- 4. rehearsal run B: probes + kill -9 + resume --------------------------
note "run B: launching with --sup_exec; will kill -9 in epoch 2"
rm -rf "$WORK/runB"
python -m pase_tpu_torch.train "${TRAIN_ARGS[@]}" --save_path "$WORK/runB" \
    --sup_exec "$WORK/sup_cmd.txt" --sup_freq 2 >> "$LOG" 2>&1 &
echo $! > "$WORK/runB.pid"

# a train line after the second epoch's perf line: epoch 1 is saved (its
# FE_e1.npz and probe launched) and epoch 2 is under way
in_epoch2() {
    [ -f "$WORK/runB/FE_e1.npz" ] && awk '
        /"split": "perf"/ { p++ }
        p >= 2 && /"split": "train"/ { found = 1 }
        END { exit !found }' "$WORK/runB/metrics.jsonl" 2>/dev/null
}
for _ in $(seq 1 24000); do
    in_epoch2 && break
    if ! kill -0 "$(cat "$WORK/runB.pid")" 2>/dev/null; then
        fail "run B exited before a step of epoch 2 was logged"
    fi
    sleep 0.1
done
in_epoch2 || fail "run B logged no step of epoch 2 in time"
kill -9 "$(cat "$WORK/runB.pid")" 2>/dev/null || true
wait "$(cat "$WORK/runB.pid")" 2>/dev/null || true
if [ -f "$WORK/runB/FE_e$LAST.npz" ]; then
    fail "run B finished before the kill landed — raise HOURS/EPOCHS"
fi
KILLED_AT=$(awk -F'"step": ' '/"split": "train"/ { split($2, a, /[,}]/);
    s = a[1] } END { print s }' "$WORK/runB/metrics.jsonl")
note "run B killed (-9) at logged step $KILLED_AT (epoch 2); resuming"
lap "4a (run B to the kill)"

python -m pase_tpu_torch.train "${TRAIN_ARGS[@]}" --save_path "$WORK/runB" \
    --sup_exec "$WORK/sup_cmd.txt" --sup_freq 2 >> "$LOG" 2>&1
note "run B resumed and finished"
lap "4b (run B resumed)"

# ---- 5. A == B --------------------------------------------------------------
# Bit for bit, as the JAX script holds it. Where the card's default cuDNN /
# cuBLAS algorithms are not deterministic, two uninterrupted runs already
# differ: there B is held to within twice the spread of A and A2
# (chip_smoke.py phase 11's rule). On the CPU the runs are deterministic
# and only bit for bit passes.
differ() {      # "<arrays that differ> <arrays> <max |X - Y| / max |X|>"
    python - "$WORK/$1/FE_e$LAST.npz" "$WORK/$2/FE_e$LAST.npz" <<'PY'
import sys
import numpy as np
a, b = np.load(sys.argv[1]), np.load(sys.argv[2])
assert sorted(a.files) == sorted(b.files)
bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
rel = max((float(np.abs(a[k].astype(np.float64) - b[k]).max()
                 / max(float(np.abs(a[k]).max()), 1e-30)) for k in bad),
          default=0.0)
print(len(bad), len(a.files), repr(rel))
PY
}
read -r NDIFF NARR REL <<< "$(differ runA runB)"
if [ "$NDIFF" -eq 0 ]; then
    note "PASS: FE_e$LAST bitwise equal across kill -9 + resume ($NARR arrays)"
elif [ "$DEVICE" = cpu ]; then
    fail "weights differ after preemption+resume: $NDIFF of $NARR arrays, max |A - B| / max |A| $REL"
else
    note "FE_e$LAST: $NDIFF of $NARR arrays differ after kill -9 + resume (max |A - B| / max |A| $REL); run A2 gives the card's run-to-run spread"
    read -r NDIFF2 _ SPREAD <<< "$(differ runA runA2)"
    if ! awk -v r="$REL" -v s="$SPREAD" 'BEGIN { exit !(s > 0 && r <= 2 * s) }'; then
        fail "weights differ after preemption+resume: max |A - B| / max |A| $REL, more than twice the uninterrupted runs' spread $SPREAD ($NDIFF2 of $NARR arrays differ there)"
    fi
    note "PASS: FE_e$LAST within 2x the run-to-run spread across kill -9 + resume ($NARR arrays, $NDIFF differ: max |A - B| / max |A| $REL; two uninterrupted runs $SPREAD, $NDIFF2 differ)"
fi
lap "5 (A against B)"

# ---- 6.-7. export + serving parity ------------------------------------------
# forward-chunk (beside the export, which it does not read) in windows of
# the export's bucket: a wav of exactly 8 s fills the 128000 bucket, and
# forward-chunk's default 160000-sample window would zero-pad it where the
# bucket does not, so the reflect padding of the last frames' receptive
# field would see other samples
HELD=$(ls "$WORK/corpus/wavs" | tail -1)
python -m pase_tpu_torch.util_scripts forward-chunk --fe_cfg "$FE_CFG" \
    --fe_ckpt "$WORK/runB/FE_e$LAST.npz" \
    --in_wav "$WORK/corpus/wavs/$HELD" --out_file "$WORK/direct.npy" \
    --chunk_size 128000 --device "$DEVICE" >> "$WORK/direct.log" 2>&1 &
DIRECT_PID=$!
note "export from run B final checkpoint"
python -m pase_tpu_torch.util_scripts export --fe_cfg "$FE_CFG" \
    --fe_ckpt "$WORK/runB/FE_e$LAST.npz" --out_dir "$WORK/export" \
    --chunk_sizes 128000 --device "$DEVICE" >> "$LOG" 2>&1
lap "6 (export)"

python -m pase_tpu_torch.util_scripts serve-encode --export_dir "$WORK/export" \
    --in_wav "$WORK/corpus/wavs/$HELD" --out_file "$WORK/served.npy" \
    >> "$LOG" 2>&1
wait "$DIRECT_PID" || fail "forward-chunk failed: see $WORK/direct.log"
python - "$WORK" <<'PY' | tee -a "$LOG"
import sys
import numpy as np
work = sys.argv[1]
served = np.load(f"{work}/served.npy")
direct = np.load(f"{work}/direct.npy")
assert served.shape == direct.shape, (served.shape, direct.shape)
err = float(np.abs(served - direct).max())
assert err < 2e-4, f"serving mismatch: max|err|={err}"
print(f"[rehearsal] PASS: serve-encode == forward-chunk "
      f"(shape {served.shape}, max|err|={err:.2e})")
PY
lap "7 (serving)"

# ---- 8. the probe ran AND pretraining beats a random encoder ----------------
# every epoch the superviser fires on: (e + 1) % 2 == 0, and the last
WANT=""
for e in $(seq 0 "$LAST"); do
    if [ $(((e + 1) % 2)) -eq 0 ] || [ "$e" -eq "$LAST" ]; then
        WANT="$WANT $e"
    fi
done
probes_running() {     # a probe child of run B still alive (or no pgrep)
    command -v pgrep > /dev/null || return 0
    pgrep -f "pase_tpu_torch.run_probe utt .*$WORK/probe_tr.lst" > /dev/null
}
for _ in $(seq 1 1200); do
    missing=0
    for e in $WANT; do
        [ -f "$WORK/runB/sup_aux/probe_$e.json" ] || missing=1
    done
    [ "$missing" -eq 0 ] && break
    probes_running || break       # a probe that failed writes no JSON
    sleep 0.5
done
# transfer margin: the same probe with an untrained (random-init) encoder
# of the same architecture (the transfer gate, rehearsal-sized), started
# beside step 3
wait "$RANDOM_PID" || fail "the random-init probe failed: see $WORK/probe_random.log"
python - "$WORK" $WANT <<'PY' | tee -a "$LOG"
import json
import os
import sys
work, want = sys.argv[1], sys.argv[2:]
outs = [f"{work}/runB/sup_aux/probe_{e}.json" for e in want]
missing = [p for p in outs if not os.path.exists(p)]
assert not missing, f"no probe output — AuxiliarSuperviser never fired: {missing}"
m = json.load(open(outs[-1]))
acc = m.get("test_sentence_acc")
assert acc is not None and 0.0 <= acc <= 1.0, m
rnd = json.load(open(f"{work}/probe_random.json"))["test_sentence_acc"]
with open(f"{work}/probe_te.lst") as f:
    speakers = {line.split()[1] for line in f if line.strip()}
chance = 1.0 / len(speakers)
# the trained encoder must (a) beat chance decisively and (b) not be
# WORSE than random init; strict improvement is asserted only when the
# random encoder has not already saturated the (small) rehearsal corpus
assert acc > chance + 0.15, (acc, chance)
assert acc >= rnd - 1e-9, (acc, rnd)
if rnd < 0.95:
    assert acc > rnd, f"pretraining did not improve the probe: {acc} vs {rnd}"
print(f"[rehearsal] PASS: probe ran ({len(outs)} firings); pretrained "
      f"acc {acc:.3f} vs random-init {rnd:.3f} (chance {chance:.2f})")
PY
lap "8 (probes)"

note "REHEARSAL COMPLETE — all assertions passed"
