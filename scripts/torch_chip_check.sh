#!/bin/bash
# The PyTorch port's whole check on one H100, run from the root of a
# checkout: the `gpu` tests, `python3 chip_smoke.py`, and
# `chip_smoke.py` alone in an empty directory, where it must fail.
# Everything the runs write goes to OUT_DIR; the tails of the smoke's
# output end this script's, and its exit code is the smoke's.
#
#   scripts/torch_chip_check.sh OUT_DIR
set -u
out=${1:?usage: scripts/torch_chip_check.sh OUT_DIR}
mkdir -p "$out"
echo "tree $(pwd)"
PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py \
    -p no:cacheprovider > "$out/gpu_tests.txt" 2>&1
echo "gpu tests exit $?"
tail -n 3 "$out/gpu_tests.txt"
python3 chip_smoke.py > "$out/smoke_stdout.txt" 2> "$out/smoke_stderr.txt"
rc=$?
echo "chip_smoke exit $rc"
for f in chip_smoke.json plan_explain_cli.txt plans_explain.txt dist_gloo.log dist_nccl.log; do
    cp "chiprun_out/$f" "$out/" 2>/dev/null
done
alone=$(mktemp -d)
cp chip_smoke.py "$alone/"
(cd "$alone" && python3 chip_smoke.py > /dev/null 2>&1; echo "alone exit $?")
rm -rf "$alone"
tail -c 12000 "$out/smoke_stdout.txt"
tail -c 2000 "$out/smoke_stderr.txt"
exit $rc
