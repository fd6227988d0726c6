"""Test fake: yields the original video three times (no degradation).

The port's copy of ``vhr_tpu/analysis/degradation/dummy.py``, line for line
below this docstring: the end-to-end smoke plugin.
"""

from typing import Generator, Tuple


def apply(input_path: str) -> Generator[Tuple[str, str], None, None]:
    for i in range(1, 4):
        yield input_path, f"Dummy {i}"
