"""The web GUI shell (mirrors ddsp_svc_tpu/gui/): the realtime engine's
controls, file conversion and the training workflow over HTTP."""
from .i18n import LOCALES, get_locale  # noqa: F401
from .web import DEFAULTS, GuiApp, serve  # noqa: F401
