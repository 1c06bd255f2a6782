"""From the process's start to the port's entry module imported (``import
torch`` and ``contrastyou_tpu_torch.main``), by the host clock."""


def read(rec):
    return rec.import_s
