"""Share of the masks the port's ``find_contours`` traced in the host C
library (counter ``contours.native``) rather than in Python
(``contours.plain``), in %, over the traced slide (``harness/spans.py``):
100 where the card's host builds the library."""

from portbench.harness.spans import totals


def read(ctx):
    got = totals()
    if got is None:
        return None
    native = got[1].get("contours.native", 0)
    plain = got[1].get("contours.plain", 0)
    if native + plain == 0:
        return None
    return 100.0 * native / (native + plain)
