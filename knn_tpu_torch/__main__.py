from knn_tpu_torch.cli import main

main()
