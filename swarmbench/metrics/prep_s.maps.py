"""Host search and corridors: the seconds of the harness's span around
parallel.scenarios.prep_scenarios, the mean over the window's batches."""


def read(record: dict):
    spans = [b - a for name, a, b in record["spans"] if name == "prep"]
    return sum(spans) / len(spans) if spans else None
