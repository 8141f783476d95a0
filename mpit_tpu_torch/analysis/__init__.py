"""Runtime sanitizers of the port (RT101-RT104): ``analysis/runtime.py``,
a copy of ``mpit_tpu/analysis/runtime.py``. The static rules and trace
conformance stay in the reference (``python -m mpit_tpu.analysis``)."""
