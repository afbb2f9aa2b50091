"""Shared logger (same format as gance_tpu's, under the port's own name)."""

import logging
import sys

LOGGER_FORMAT = "%(asctime)s - %(process)d - %(name)s - %(levelname)s - %(message)s"

logging.basicConfig(level=logging.INFO, format=LOGGER_FORMAT, stream=sys.stderr)

LOGGER = logging.getLogger("gance_tpu_torch")


def add_log_file(path) -> None:
    """Attach a FileHandler to the root logger (the --log CLI contract)."""
    if path is None:
        return
    handler = logging.FileHandler(str(path))
    handler.setFormatter(logging.Formatter(LOGGER_FORMAT))
    logging.getLogger().addHandler(handler)
