"""Share of the rows the model embedded in the window that were padding:
1 - fingerprints written / rows passed to the pipeline's model calls
(counted by the cell's work module around ``FingerprintPipeline.embed``), in %."""


def read(ctx):
    embedded = ctx.counters.get("embedded_rows", 0)
    if not embedded:
        return None
    return 100.0 * (embedded - ctx.counters["rows"]) / embedded
