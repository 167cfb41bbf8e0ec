from .ate import align_umeyama, ate_rmse
