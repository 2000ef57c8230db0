from tomofastx_tpu_torch.models.grid import Grid  # noqa: F401
from tomofastx_tpu_torch.models.data import SurveyData  # noqa: F401
from tomofastx_tpu_torch.models.model import ModelState  # noqa: F401
