"""Data: the eval-set loaders and the training crop iterator."""

from tpucdc_torch.data.datasets import (EvalDataset, clic2020, eval_dataset,
                                        kodak, local_image_corpus,
                                        synthetic_images,
                                        synthetic_images_rich, tecnick,
                                        train_crop_iterator, training_corpus)

__all__ = ["EvalDataset", "eval_dataset", "kodak", "clic2020", "tecnick",
           "local_image_corpus", "synthetic_images", "synthetic_images_rich",
           "training_corpus", "train_crop_iterator"]
