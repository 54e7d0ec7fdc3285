#!/usr/bin/env bash
# The four-card runs of the device-mesh layer, one after another on a
# machine with four GPUs, each part's output in OUT (default
# build/four_cards) and its exit code on a line of this script's
# output; a failing part does not stop the next, and all parts together
# stop at BUDGET seconds.  Parts (all by default, or those named as
# arguments):
#   gpu_tests   the -m gpu cases of tests/test_torch_sharding_dist.py (NCCL, world 2 and 4)
#   train40     starcoder2-15b, all 40 layers, bf16, data 2 x model 2 (tools/train_sharded.py)
#   train2      the same at 2 layers in fp32, with rank 0's one-card twin
#   serve80     qwen2-72b, all 80 layers, bf16, model 4 (tools/serve_sharded.py)
#   serve4      qwen2-72b at 4 layers in fp32: one card, then model 4 against it (1e-4)
# CKPT (default build/train_sharded_ckpt) is train40's checkpoint directory,
# ~128 GB written and read back: where the machine's disk takes fewer
# writes a call, point it at memory (a tmpfs such as /dev/shm).
set -u
cd "$(dirname "$0")/.."
OUT=${OUT:-build/four_cards}
mkdir -p "$OUT" build
export PYTHONPATH=src
export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True  # the 40-layer step's leaves
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, torch.cuda.device_count())'
python3 -c 'from repro_torch.kernels import build; print(build.build())'  # once, before the ranks
parts=${*:-train40 serve80 gpu_tests train2 serve4}
BUDGET=${BUDGET:-1700}  # seconds for all parts: a part gets at most what is left
run() {  # name, seconds, command...
  local name=$1 limit=$2; shift 2
  local left=$((BUDGET - SECONDS))
  if [ "$left" -lt 60 ]; then echo "part $name not run: the budget is spent"; return; fi
  [ "$limit" -gt "$left" ] && limit=$left
  local t0=$SECONDS
  timeout "$limit" "$@" > "$OUT/$name.log" 2>&1
  local rc=$?
  echo "part $name rc=$rc $((SECONDS - t0)) s"
  tail -n 4 "$OUT/$name.log"
}
for part in $parts; do
  case $part in
    gpu_tests) run gpu_tests 420 python3 -m pytest -q -m gpu -s -p no:cacheprovider \
                 tests/test_torch_sharding_dist.py ;;
    train40) run train40 900 torchrun --nproc-per-node 4 tools/train_sharded.py \
               --arch starcoder2-15b --data 2 --model 2 --batch 8 --seq 2048 \
               --ckpt "${CKPT:-build/train_sharded_ckpt}" ;;
    train2) run train2 420 torchrun --nproc-per-node 4 tools/train_sharded.py \
              --arch starcoder2-15b --data 2 --model 2 --batch 8 --seq 2048 --layers 2 \
              --dtype float32 --twin ;;
    serve80) run serve80 600 torchrun --nproc-per-node 4 tools/serve_sharded.py \
               --arch qwen2-72b --model 4 --seq 8192 --batch 4 ;;
    serve4) run serve4_one 300 python3 tools/serve_sharded.py --arch qwen2-72b \
              --layers 4 --dtype float32 --save build/serve4_one.npz
            run serve4 300 torchrun --nproc-per-node 4 tools/serve_sharded.py \
              --arch qwen2-72b --layers 4 --dtype float32 --model 4 \
              --against build/serve4_one.npz ;;
    *) echo "unknown part $part"; exit 2 ;;
  esac
done
