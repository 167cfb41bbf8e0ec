from .vocab import (Vocabulary, train_vocabulary, assign_words, bow_vector, bow_similarity,
                    save_vocabulary, load_vocabulary)
from .detector import LoopCloser, LoopConfig, LoopResult, LoopVerdict, correct_loop
from .sim3_solve import umeyama_sim3, robust_sim3_from_matches
from .pose_graph import optimize_pose_graph, PoseGraphProblem
