# Task runner, mirroring the reference's Justfile (pylint / unit-tests /
# benchmark) plus the native build.

native:
	make -C native

pylint:
	pylint --disable=all --enable=E stereomatch_tpu

unit-tests:
	python -m pytest tests/ -q

benchmark:
	python benchmarks/suite.py

headline:
	python bench.py

# Mirrors the reference's download-middlebury recipe
# (workflows/evaluation/Justfile:5-7); needs network.
fetch-middlebury:
	python -m stereomatch_tpu.cli.fetch middlebury2021 --dest data/middlebury

fetch-teddy:
	python -m stereomatch_tpu.cli.fetch teddy2003 --dest data

# Real-data runbook (README "Real-data runbook"): fetch the reference's
# fixture scenes and produce the bad-pixel-vs-GT table.  Needs network
# for the fetch; the eval runs offline afterwards, and
# tests/test_real_eval.py asserts the pre-registered acceptance range
# whenever the data exists.
real-eval:
	python -m stereomatch_tpu.cli.fetch teddy2003 --dest data/middlebury2003
	python -m stereomatch_tpu.cli.fetch cones2003 --dest data/middlebury2003
	python -m stereomatch_tpu.cli.evaluate data/middlebury2003 \
	  --configs census:wta:sgm,ssd:wta:sgm --json real_eval.json

dryrun-multichip:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "import jax; jax.config.update('jax_platforms', 'cpu'); import __graft_entry__ as g; g.dryrun_multichip(8)"

# On a machine with an NVIDIA Hopper GPU: the hardware test tier plus the
# main path end to end (chip_smoke.py runs the tier as its first phase).
chip-smoke:
	python3 chip_smoke.py

# The SGM kernel library, ahead of first use (git-ignored build dir).
sgm-kernel:
	python -m stereomatch_tpu.ops.sgm_cuda

serve:
	python -m stereomatch_tpu.cli.serve 128 -cm census --dtype bfloat16 \
	  --batch 8 --warmup 375x450
