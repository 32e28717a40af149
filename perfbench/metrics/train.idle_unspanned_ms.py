"""Milliseconds an update in which the device ran nothing while the
stepping thread was in none of the program's spans (openeat.step,
openeat.loader.wait, openeat.feed and those inside them): the idle time
the spans cannot name, traced window (perfbench/spans.py)."""

from perfbench.spans import idle_unspanned_ms


def read(ctx):
    return idle_unspanned_ms(ctx)
