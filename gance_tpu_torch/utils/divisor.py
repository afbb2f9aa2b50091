"""
Division that refuses to lose a remainder (a copy of gance_tpu/utils/divisor.py).

Used to validate fps multipliers. Accepts floats so that inexact rates (29.97
fps) are rejected rather than silently rounded to the nearest integer rate.
"""

import math
from typing import Union


def divide_no_remainder(
    numerator: Union[int, float], denominator: Union[int, float]
) -> int:
    """
    Divide `numerator` by `denominator`, raising if the division has a remainder.

    :raises ValueError: if the division is not exact (the fractional part of the
        quotient by ``math.modf``, so 29.97/30 raises rather than passing as 30/30).
    """
    if denominator == 0:
        raise ValueError("Division by zero.")
    fractional, whole = math.modf(numerator / denominator)
    if fractional != 0:
        raise ValueError(
            f"{numerator} / {denominator} is not exact (fractional part {fractional});"
            " expected exact division."
        )
    return int(whole)
