"""Benches of the port: kernel rooflines (:mod:`.kernel`), the train step
and end-to-end epochs (:mod:`.step`), and the timing they share
(:mod:`.timing`)."""
