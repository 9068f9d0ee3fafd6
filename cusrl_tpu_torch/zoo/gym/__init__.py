from cusrl_tpu_torch.zoo.gym import box2d, classic_control
