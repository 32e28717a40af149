"""Milliseconds an update waited on the feeder's next batch (the
harness's clock around the DeviceFeeder iterator: the loader's collate
threads and the frontend's launches), over the measured (untraced)
window."""


def read(ctx):
    rec = ctx.record
    if ctx.kind != "train" or not rec.updates:
        return None
    return 1e3 * sum(rec.input_wait_s) / rec.updates
