"""Structure from motion: bundle adjustment, chunk reconstruction, Sim3
chunk alignment (port of ``pi3_slam_tpu/sfm``)."""
