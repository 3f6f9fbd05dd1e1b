"""Hand model: assets, forward kinematics, linear blend skinning."""

from spherehand_torch.hand.assets import (  # noqa: F401
    HandModel,
    load_hand_model,
    load_pose_prior_pca,
)
from spherehand_torch.hand.kinematics import forward_kinematics  # noqa: F401
from spherehand_torch.hand.skinning import (  # noqa: F401
    apply_random_scale,
    apply_scale,
    draw_random_scale,
    inverse_orthographic,
    lbs_faces,
    lbs_keypoints,
    lbs_mesh,
    orthographic_project,
    orthographic_project_xyz,
    project_faces_planes,
)
from spherehand_torch.hand.skeleton import skeleton_fk  # noqa: F401
