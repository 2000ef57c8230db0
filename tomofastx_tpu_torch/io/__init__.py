from tomofastx_tpu_torch.io.model_io import (  # noqa: F401
    read_model_grid,
    read_model_values,
    set_model,
    write_model_ascii,
    read_bound_constraints,
    set_model_bounds,
    read_damping_gradient_weights,
    read_damping_weights,
    read_local_weights,
    read_vector_field,
)
from tomofastx_tpu_torch.io.data_io import read_data_points, write_data_points  # noqa: F401
