from .camera import Camera, camera_rays  # noqa: F401
from .renderer import Renderer, RenderConfig  # noqa: F401
