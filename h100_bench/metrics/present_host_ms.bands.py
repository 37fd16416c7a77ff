"""present_host_ms.bands: present_host_ms in a cell whose end-to-end
metrics are fps and setup_s alone (the bands cell): host ms a frame inside
runtime.PresentQueue.push and the arrival on rank 0, over the traced run's
spans window."""
from h100_bench.metrics.present_host_ms import read  # noqa: F401
