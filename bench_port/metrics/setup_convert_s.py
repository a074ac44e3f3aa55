"""Host conversion and upload of set-up's first prepare_ir: the program's
ledger phases ``reorder_convert`` + ``upload``."""


def read(run):
    p = run.phases_setup
    if not p or "reorder_convert" not in p:
        return None
    return p["reorder_convert"] + p.get("upload", 0.0)
