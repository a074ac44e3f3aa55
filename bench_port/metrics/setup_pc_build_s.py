"""The preconditioner's build in set-up's first prepare_ir: the program's
ledger phase ``pc_build`` (saamg's ``saamg_*`` phases run inside it)."""


def read(run):
    return run.phases_setup.get("pc_build")
