# Developer entry points. See CLAUDE.md for how tests and the GPU runs work.
.PHONY: test test-all smoke bench bench-boot native clean

test:
	python -m pytest tests/ -q

test-all:
	python -m pytest tests/ -q -m ""

smoke:
	python chip_smoke.py

bench:
	python bench.py

bench-boot:
	python bench_boot.py

native:
	$(MAKE) -C native

clean:
	$(MAKE) -C native clean
