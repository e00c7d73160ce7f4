"""ms a step in the span `graph_prep` (spans/graph_prep.json), synchronized split."""

from benchmark.metrics import span_ms

SPANS = ("graph_prep",)


def read(record):
    return span_ms(record, SPANS[0])
