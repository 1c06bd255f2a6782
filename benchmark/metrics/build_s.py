"""The run's build (``main.build_semi_run`` / ``build_pretrain_run``) with
the seed's weights and slices loaded into it, synchronized."""


def read(rec):
    return rec.build_s
