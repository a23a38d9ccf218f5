"""The reference's seven demo mains on the port (SURVEY §0: clahe,
clahe_img_keypoint, ORB_SLAM_Extractor, distribute_oct_tree,
whole_extractor, frame, matcher), each run as
``python -m extractorb_tpu_torch.demos.<name> [--device cpu]`` and callable
in process as ``main(argv)``.  They run on the card unless given
``--device cpu``, on the in-repo procedural texture unless given
``--image``."""
