# Development/CI image (reference parity: Dockerfile + docker.justfile).
# GPU runtime images come from your accelerator platform (CUDA toolkit for
# the SGM kernel's nvcc build); this image is for CPU development and the
# test suite (8-device virtual mesh).
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        g++ make \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/stereomatch_tpu
COPY pyproject.toml README.md ./
COPY stereomatch_tpu ./stereomatch_tpu
COPY native ./native
COPY benchmarks ./benchmarks
COPY bench.py ./

RUN pip install --no-cache-dir -e ".[io,test]" && make -C native

COPY tests ./tests
ENV JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8

CMD ["python", "-m", "pytest", "tests/", "-q"]
