from . import eagen_msm
