from tomofastx_tpu_torch.config.parfile import (  # noqa: F401
    Config,
    GravParams,
    MagParams,
    InversionParams,
    read_parfile,
    parse_parfile_lines,
)
