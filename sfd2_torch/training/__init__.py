"""Training: ResSegNetV2 distilled from SuperPoint and the semantic teacher
(port of ``sfd2_tpu/training``)."""
