"""pipeline.launches_per_batch: device kernels, copies and sets in the traced
window over its batches; the pipeline's fixed cost a batch (launches, host
syncs between them), which a batch's latency pays."""


def read(window):
    if window.batches <= 0 or not window.events:
        return None
    return len(window.events) / window.batches
