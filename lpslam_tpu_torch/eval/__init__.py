from .ate import align_umeyama, ate_rmse, rpe_rmse
