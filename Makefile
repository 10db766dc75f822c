# tensorflow-nufft-tpu build pipeline.
#
# Role parity with the reference's Makefile (reference: Makefile:118-142,
# targets lib/test/benchmark/wheel/docs/lint), adapted to this framework:
# the device path is JAX/XLA/Pallas (nothing to build ahead), the native
# CPU engine builds from cc/nufft_cpu.cc, and protos regenerate with protoc.

PYTHON ?= python
PROTOC ?= protoc
CXX ?= g++

PKG := tensorflow_nufft_tpu
SO := build/libtfft_cpu.so

all: lib

# Native CPU engine (also built lazily at import time by native/engine.py).
lib: $(SO)

$(SO): cc/nufft_cpu.cc
	mkdir -p build
	$(CXX) -O3 -march=native -fPIC -shared -fopenmp -o $@ $<

# Regenerate the options proto bindings (wire-compatible with the
# reference's proto/nufft_options.proto field numbering).
proto: $(PKG)/proto/nufft_options.proto
	$(PROTOC) --python_out=. $(PKG)/proto/nufft_options.proto

test:
	$(PYTHON) -m pytest tests/ -q

test-fast:
	$(PYTHON) -m pytest tests/ -q -m "not slow" -x

benchmark:
	$(PYTHON) bench.py

benchmark-suite:
	$(PYTHON) bench_suite.py

lint:
	$(PYTHON) -m pyflakes $(PKG) tests bench.py bench_suite.py \
	  __graft_entry__.py 2>/dev/null || \
	  $(PYTHON) -m py_compile $$(find $(PKG) tests -name '*.py') \
	    bench.py bench_suite.py __graft_entry__.py

wheel:
	$(PYTHON) setup.py bdist_wheel

docs:
	$(PYTHON) docs/gen_api.py
	$(PYTHON) docs/build_site.py

clean:
	rm -rf build dist *.egg-info .pytest_cache
	find . -name __pycache__ -type d -prune -exec rm -rf {} +

.PHONY: all lib proto test test-fast benchmark benchmark-suite lint wheel docs clean
