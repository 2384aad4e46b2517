"""CLI entry: ``python -m dlrm_flexflow_tpu_torch.telemetry report
<run.jsonl|dir>`` (and ``regress``, ``export-trace``)."""

import sys

from .report import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
