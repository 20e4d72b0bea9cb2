"""rows_per_s.<mix>: rows of the tables the completed queries scan (each
FROM reference once), over the window's seconds on the host's clock. The
window runs from the start of its first query to the end of its last; it
ends after the first whole round that ends past `--seconds`. Split by mix
(`rows_per_s.join`, `rows_per_s.pricing`), so each mix has a bound of its
own."""


def read(obs, name):
    done = obs.completed
    if not done or obs.window_s <= 0:
        return None
    return sum(q.scanned for q in done) / obs.window_s
