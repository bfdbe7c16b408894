"""The device's idle share of the traced window: 100 (1 - busy / window),
busy the union of the device operations' intervals on the profiler's
timeline."""


def read(record: dict):
    tr = record.get("trace") or {}
    return tr.get("idle_pct")
