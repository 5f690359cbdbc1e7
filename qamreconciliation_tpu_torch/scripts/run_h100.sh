#!/usr/bin/env bash
# Every campaign once at the JAX scripts' defaults (N = 64800, B = 128,
# 1024 frames a point, maxiter 50) on one card, then the sweeps the five
# plotters read, then every variant of the attribution probes at the JAX
# probes' defaults.  Outputs go to OUT (default
# qamreconciliation_tpu_torch/scripts/h100), named as in docs/img: each
# campaign's records in OUT/<name>.jsonl, its progress in OUT/<name>.log,
# and one line of wall seconds a campaign in OUT/wall_s.txt; each probe
# variant's records in OUT/probes/<probe>_<variant>.jsonl (its progress in
# .log beside it, its wall seconds in OUT/probes/wall_s.txt).  Run from
# the repository root:
#
#     bash qamreconciliation_tpu_torch/scripts/run_h100.sh [OUT [WHAT]]
#
# WHAT is "all" (default), "campaigns", "probes" or "last_probes" (only
# the six probes of kernels 8 and 9 and the decode, round, streaming and
# F/B-form probes).  A campaign or probe that exits non-zero is reported
# and the script goes on; it exits 1 at the end if any did.
set -u
OUT=${1:-qamreconciliation_tpu_torch/scripts/h100}
WHAT=${2:-all}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$OUT/card.txt"
M=qamreconciliation_tpu_torch.scripts
# the mode comparison's sweep flags (run_r5_dvbs2's wf step has them too)
MODES="--simloops 1024 --batch 128 --maxiter 50 --ferr-count-min 1000000000 --dtype bfloat16 --check-phi tanhfb"
# the plotters' sweeps: 1024 frames a point, early exit off
WF="--simloops 1024 --batch 128 --maxiter 50 --ferr-count-min 1000000000"
failed=0

run() {  # run NAME MODULE ARGS...: records to $DIR/NAME.jsonl
    local name=$1 module=$2
    shift 2
    local t0=$SECONDS
    python3 -m "$M.$module" "$@" > "$DIR/$name.jsonl" 2> "$DIR/$name.log"
    local rc=$?
    echo "$name $((SECONDS - t0)) rc=$rc" | tee -a "$DIR/wall_s.txt"
    [ $rc -eq 0 ] || failed=1
}

last_probes() {  # kernels 8 and 9 and the driver probes, JAX defaults
    run probe_vmem probe_vmem
    for v in nobook violonly nocapture full; do
        run "probe_resident_vmem_$v" probe_resident_vmem --variant $v
    done
    run probe_fb_form probe_fb_form
    run probe_decode_dense probe_decode
    run probe_decode_dense_pallas0 probe_decode --pallas 0
    run probe_decode_generic probe_decode --qc 0
    run probe_decode_resident probe_decode --resident 1
    run probe_decode_resident_nbv180 probe_decode --resident 1 --nbv 180
    run probe_decode_resident_ira probe_decode --resident 1 --ira 1 \
        --nbv 180
    run probe_decode_layered_resident probe_decode --schedule layered \
        --resident 1 --check minsum
    run probe_round_bps4 probe_round
    run probe_round_bps2 probe_round --bps 2
    run probe_streaming_defer probe_streaming
    run probe_streaming_fused probe_streaming --fused 1
    run probe_streaming_handoff probe_streaming --handoff 1
}

probes() {  # every probe variant at the JAX defaults
    DIR=$OUT/probes
    mkdir -p "$DIR"
    : > "$DIR/wall_s.txt"
    for m in phi copy minsum; do
        for d in bfloat16 float32; do
            run "probe_check_math_${m}_$d" probe_check_math --math $m --dtype $d
        done
    done
    for d in bfloat16 float32; do
        run "probe_qc_parts_rolls_$d" probe_qc_parts --part rolls --dtype $d
        run "probe_qc_parts_check_pallas1_$d" probe_qc_parts --part check \
            --pallas 1 --dtype $d
        run "probe_qc_parts_check_pallas0_$d" probe_qc_parts --part check \
            --pallas 0 --dtype $d
    done
    for g in 1 0; do
        for p in sweep parity full; do
            run "probe_layered_parts_${p}_grouped$g" probe_layered_parts \
                --part $p --grouped $g
        done
    done
    run probe_preamble_bps2 probe_preamble
    run probe_preamble_bps4 probe_preamble --bps 4
    run probe_preamble_bps2_bf16_poly probe_preamble --dtype bfloat16 \
        --fy-mode poly
    for v in full poly nogather nonewton noexp; do
        run "probe_mcmi_parts_$v" probe_mcmi_parts --variant $v
    done
    run probe_bf16pack_mac_exp probe_bf16pack
    last_probes
}

if [ "$WHAT" = probes ]; then
    probes
    exit $failed
fi
if [ "$WHAT" = last_probes ]; then
    DIR=$OUT/probes
    mkdir -p "$DIR"
    : > "$DIR/wall_s.txt"
    last_probes
    exit $failed
fi
DIR=$OUT
: > "$OUT/wall_s.txt"

run r5_dvbs2 run_r5_dvbs2 --outdir "$OUT"
run wf_dvbs2_12_hard run_waterfall "$OUT/wf_dvbs2_12_hard.csv" --dvbs2 1/2 \
    --hard --snr 3.0 5.5 --nsnr 6 $MODES
run wf_dvbs2_12_direct run_waterfall "$OUT/wf_dvbs2_12_direct.csv" \
    --dvbs2 1/2 --direct --snr 2.5 4.25 --nsnr 6 $MODES
run r5_knee run_r5_knee
run bps4_grid run_bps4_grid
run oms_sweep run_oms_sweep --outdir "$OUT"
run r5_sp_grid run_r5_sp_grid
run r5_grid1 run_r5_stream_grid
run r5_mi_grid run_r5_mi_grid

# the plotters' inputs, on the QC(3,6) z = 1800 code (the QC-IRA code with
# --irregular); the CLI's defaults (float32, phi sum-product) where the
# name says nothing else
G="--snr 3.0 4.25 --nsnr 6 $WF"
run wf_sumproduct run_waterfall "$OUT/wf_sumproduct.csv" $G
run wf_minsum run_waterfall "$OUT/wf_minsum.csv" $G --check-rule minsum
run wf_layered_minsum run_waterfall "$OUT/wf_layered_minsum.csv" $G \
    --check-rule minsum --schedule layered
run wf_sumproduct_bf16 run_waterfall "$OUT/wf_sumproduct_bf16.csv" $G \
    --dtype bfloat16
run wf_tanhfb_resident run_waterfall "$OUT/wf_tanhfb_resident.csv" $G \
    --dtype bfloat16 --check-phi tanhfb --resident
run wf_tanhfb_resident_hybrid run_waterfall \
    "$OUT/wf_tanhfb_resident_hybrid.csv" $G --dtype bfloat16 \
    --check-phi tanhfb --resident --totals-dtype float32
I="--irregular --snr 2.75 4.0 --nsnr 6 $WF --dtype bfloat16 --check-phi tanhfb"
run wf_ira_resident run_waterfall "$OUT/wf_ira_resident.csv" $I --resident
run wf_ira_dense run_waterfall "$OUT/wf_ira_dense.csv" $I
B="--bps 4 --snr 11.0 13.5 --nsnr 6 $WF"
run bps4_soft_alt run_waterfall "$OUT/bps4_soft_alt.csv" $B
run bps4_soft_base run_waterfall "$OUT/bps4_soft_base.csv" $B \
    --configuration-base
run bps4_hard run_waterfall "$OUT/bps4_hard.csv" $B --hard
run bps4_direct run_waterfall "$OUT/bps4_direct.csv" $B --direct
[ "$WHAT" = campaigns ] || probes
exit $failed
