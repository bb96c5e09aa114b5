"""tail.serial_row_ms: ms a row of block 1's serial sweep on the card,
its row steps to the sweep's last sync over its rows
(`BatchedRealigner.card_serial_split` over the window)."""


def read(ctx):
    s = ctx.counters["card_serial_split"]
    if not s["rows"]:
        return None
    return 1e3 * s["rows_s"] / s["rows"]
